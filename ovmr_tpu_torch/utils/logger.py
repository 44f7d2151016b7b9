"""stdout tee logger.

The port's copy of ``ovmr_tpu/utils/logger.py``.

Behavioral parity with the reference (``dassl/utils/logger.py:11-72``): all
prints are mirrored into ``OUTPUT_DIR/log.txt`` so that the result parser can
scrape ``* accuracy: X%`` lines; if the file already exists a timestamp suffix
is appended.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional


class _Tee:
    def __init__(self, fpath: str):
        self.console = sys.stdout
        os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
        # line-buffered: a crashed/killed run leaves a scrapeable log.txt
        self.file = open(fpath, "w", buffering=1)

    def write(self, msg: str) -> None:
        self.console.write(msg)
        self.file.write(msg)

    def flush(self) -> None:
        self.console.flush()
        self.file.flush()
        os.fsync(self.file.fileno())

    def close(self) -> None:
        self.file.close()

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def setup_logger(output: Optional[str] = None) -> None:
    """Tee stdout to ``{output}/log.txt`` (or to `output` itself if it ends
    with .txt). Appends a timestamp suffix when the file already exists."""
    if output is None:
        return

    if output.endswith(".txt") or output.endswith(".log"):
        fpath = output
    else:
        fpath = os.path.join(output, "log.txt")

    if os.path.exists(fpath):
        fpath += time.strftime("-%Y-%m-%d-%H-%M-%S")

    sys.stdout = _Tee(fpath)
