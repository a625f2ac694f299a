"""Colored/throttled logging (ref solver_generator/util/logging.py +
ros_tools LOG_* macros with throttling).

Counterpart of mpc_planner_tpu/utils/logging.py, the same code: the port
keeps its own copy so that it imports nothing of the JAX package."""

from __future__ import annotations

import sys
import time
from typing import Dict


class _Color:
    HEADER = "\033[95m"
    OKGREEN = "\033[92m"
    WARNING = "\033[93m"
    FAIL = "\033[91m"
    BOLD = "\033[1m"
    END = "\033[0m"


_last_emit: Dict[str, float] = {}


def print_value(name, value, tab=True):
    prefix = "\t" if tab else ""
    print(f"{prefix}{_Color.BOLD}{name}{_Color.END}: {value}")

def print_header(text):
    print(f"{_Color.HEADER}{_Color.BOLD}==== {text} ===={_Color.END}")

def print_success(text):
    print(f"{_Color.OKGREEN}{text}{_Color.END}")

def print_warning(text, no_tab=False):
    prefix = "" if no_tab else "\t"
    print(f"{prefix}{_Color.WARNING}Warning: {text}{_Color.END}")

def print_error(text):
    print(f"{_Color.FAIL}Error: {text}{_Color.END}", file=sys.stderr)

def print_path(name, path):
    print_value(name, path)


def log_throttle(period_s: float, key: str, text: str) -> None:
    """LOG_*_THROTTLE equivalent."""
    now = time.time()
    if now - _last_emit.get(key, 0.0) >= period_s:
        _last_emit[key] = now
        print_warning(text, no_tab=True)
