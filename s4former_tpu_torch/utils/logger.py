"""Root logger (counterpart of ``s4former_tpu/utils/logger.py``; reference:
mmseg/utils/logger.py:7 get_root_logger)."""
import logging
import sys
from typing import Optional

_FORMAT = '%(asctime)s - %(name)s - %(levelname)s - %(message)s'


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    """The 's4former_tpu_torch' logger, writing to stdout and, when
    ``log_file`` is given, to that file instead of an earlier one (a
    process may run several trainings one after another)."""
    logger = logging.getLogger('s4former_tpu_torch')
    if not logger.handlers:
        logger.setLevel(log_level)
        logger.propagate = False
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
    if log_file:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger
