"""TensorBoard scalar logging.

The port's counterpart of ``ovmr_tpu/utils/tensorboard.py``: the
reference's TB contract (``dassl/engine/trainer.py:240-255``, per-iteration
train scalars under ``{OUTPUT_DIR}/tensorboard``), backed by
``torch.utils.tensorboard.SummaryWriter``. Where that does not import, the
writer is a no-op that says so once on stderr. The import runs with fd 2
silenced: where TensorFlow is installed, tensorboard imports it, and its
C++ start-up logs bypass ``sys.stderr``.
"""

from __future__ import annotations

import contextlib
import os
import sys

_WARNED_DISABLED = False


@contextlib.contextmanager
def _quiet_fd_stderr():
    """Silence fd 2 (C++-level stderr) for the duration of the block;
    without fd juggling the block runs unsilenced."""
    try:
        saved = os.dup(2)
        devnull = os.open(os.devnull, os.O_WRONLY)
    except OSError:
        yield
        return
    try:
        sys.stderr.flush()
        os.dup2(devnull, 2)
        yield
    finally:
        os.dup2(saved, 2)
        os.close(saved)
        os.close(devnull)


class SummaryWriter:
    def __init__(self, log_dir: str):
        self._writer = None
        try:
            os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
            with _quiet_fd_stderr():
                from torch.utils.tensorboard import SummaryWriter as _Writer

            self._writer = _Writer(log_dir)
        except ImportError as exc:
            global _WARNED_DISABLED
            if not _WARNED_DISABLED:
                _WARNED_DISABLED = True
                print(
                    "[ovmr_tpu_torch] tensorboard logging DISABLED: "
                    f"torch.utils.tensorboard unavailable ({exc}); train scalars "
                    f"will not be written under {log_dir!r}",
                    file=sys.stderr,
                )

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, value, global_step)

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
