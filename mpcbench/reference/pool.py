"""The reference's check on the host's cores, after the window: each task (a
module-level function and its arguments) runs in a worker process on the
CPU, which never opens the card, with one thread each. The pool is closed
and every worker has ended before `run` returns.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Callable, List, Optional, Sequence, Tuple

Task = Tuple[Callable, tuple]


def default_workers() -> int:
    """One core for the parent, the others for the reference, at most 7."""
    return max(1, min(7, (os.cpu_count() or 2) - 1))


def _init() -> None:
    import torch

    torch.set_num_threads(1)


def _call(task: Task):
    fn, args = task
    return fn(*args)


def run(tasks: Sequence[Task], workers: Optional[int] = None) -> List:
    """The tasks' results, in order; in this process where one worker is
    asked for."""
    workers = default_workers() if workers is None else int(workers)
    if workers <= 1 or len(tasks) <= 1:
        return [_call(t) for t in tasks]
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""  # the workers never see the card
    try:
        pool = multiprocessing.get_context("spawn").Pool(min(workers, len(tasks)),
                                                         initializer=_init)
    finally:
        if saved is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    try:
        results = pool.map(_call, list(tasks), chunksize=1)
        pool.close()
    except BaseException:
        pool.terminate()
        raise
    finally:
        pool.join()
    return results
