"""The package logger."""

from __future__ import annotations

import logging

logger = logging.getLogger("xmhw_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(name)s %(levelname)s: %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.WARNING)
