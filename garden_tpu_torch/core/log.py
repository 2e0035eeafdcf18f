"""Leveled logging with the reference's level names.

Replaces LogSystem over the logy library (reference:
include/garden/system/log.hpp:130, GARDEN_LOG_{TRACE,DEBUG,INFO,WARN,ERROR,
FATAL} macros). TRACE and FATAL are added to the std levels.
"""

from __future__ import annotations

import logging

TRACE = 5
FATAL = logging.CRITICAL
logging.addLevelName(TRACE, "TRACE")
logging.addLevelName(FATAL, "FATAL")

_logger = logging.getLogger("garden_tpu_torch")


def get_logger(name: str = "garden_tpu_torch") -> logging.Logger:
    return logging.getLogger(name)


def set_level(level) -> None:
    if isinstance(level, str):
        level = {"TRACE": TRACE, "DEBUG": logging.DEBUG, "INFO": logging.INFO,
                 "WARN": logging.WARNING, "ERROR": logging.ERROR,
                 "FATAL": FATAL}[level.upper()]
    _logger.setLevel(level)


def trace(msg, *a): _logger.log(TRACE, msg, *a)
def debug(msg, *a): _logger.debug(msg, *a)
def info(msg, *a): _logger.info(msg, *a)
def warn(msg, *a): _logger.warning(msg, *a)
def error(msg, *a): _logger.error(msg, *a)
def fatal(msg, *a): _logger.log(FATAL, msg, *a)
