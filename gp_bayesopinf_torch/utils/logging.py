"""Root-logger file logging with session headers (counterpart of
``gp_bayesopinf_tpu/utils/logging.py``): an INFO-level file handler on the
root logger writing to ``log.log``, and a header line per session naming
the entry script and the time."""

import logging
import os
import sys
import time


def setup_logging(log_file: str = "log.log") -> str:
    """Attach a file handler to the root logger and log a session header.

    Returns the log file's path. Calling it again for the same file adds
    no second handler."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    abspath = os.path.abspath(log_file)
    for h in logger.handlers:
        if isinstance(h, logging.FileHandler) and h.baseFilename == abspath:
            break
    else:
        handler = logging.FileHandler(log_file, "a")
        handler.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
        handler.setLevel(logging.INFO)
        logger.addHandler(handler)

    main_mod = sys.modules.get("__main__")
    if main_mod is not None and hasattr(main_mod, "__file__"):
        front = f"({os.path.basename(main_mod.__file__)})"
        end = time.strftime("%Y-%m-%d %H:%M:%S")
        mid = "-" * max(1, 79 - len(front) - len(end) - 20)
        header = f"NEW SESSION {front} {mid} {end}"
    else:
        header = f"NEW SESSION {time.strftime(' %Y-%m-%d %H:%M:%S'):->61}"
    logging.info(header)
    print(f"Logging to {log_file}")
    return log_file
