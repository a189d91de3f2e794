"""Logging and device info (counterpart of
raytracingthenextweekcuda_tpu/utils/log.py): one stdlib logger namespace,
and the report the render CLI prints first, as the reference CUDA renderer
dumps the GPU's properties (Utils.h:135-164)."""

from __future__ import annotations

import logging

import torch


def get_logger(name: str = "rtnw-torch") -> logging.Logger:
    """The logger `name`, given on first use a stderr handler that prints
    `[LEVEL name] message` and the level INFO, as the reference's."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(levelname)s %(name)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def report_devices() -> str:
    """Device inventory string (Utils::queryDeviceProperties analogue): the
    CUDA cards torch sees, with their SMs and memory, or none."""
    lines = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            lines.append(f"cuda:{i} {p.name} sm_{p.major}{p.minor} "
                         f"{p.multi_processor_count} SMs "
                         f"{p.total_memory / 2**30:.1f} GiB")
    return (f"torch={torch.__version__} cuda={torch.version.cuda} "
            f"devices=[{'; '.join(lines)}]")
