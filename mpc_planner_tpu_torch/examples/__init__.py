"""Runnable examples of the port (counterparts of the repository's
examples/01-06): `python -m mpc_planner_tpu_torch.examples.<name>`, on the
card by default, `--device cpu` for the plain versions on the CPU."""

import argparse


def parser(description: str) -> argparse.ArgumentParser:
    """The examples' command line: `--device` (default the card, cuda)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap
