"""Small utilities (counterpart of ``tpucv/utils/misc.py``). tpucv's
``load_yaml`` and ``download_file`` are left out: nothing in either package
calls them, and the port fetches nothing from a network."""

from __future__ import annotations

import random
import time
from typing import Any

import torch


def get_current_format_time() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S")


def get_format_filename(model_name: str, dataset_name: str,
                        addition: str = "") -> str:
    return f"{model_name}_{dataset_name}{('_' + addition) if addition else ''}"


def get_random_number(a: int = 0, b: int = 100) -> int:
    return random.randint(a, b)


def move_to_device(tree: Any, device) -> Any:
    """Move every tensor in a nested dict / list / tuple to ``device``;
    other leaves are returned as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: move_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(move_to_device(v, device) for v in tree)
    return tree


def colorstr(*args) -> str:
    """ANSI colour wrap."""
    *prefix, string = args if len(args) > 1 else ("blue", "bold", args[0])
    colors = {
        "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
        "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
        "cyan": "\033[36m", "white": "\033[37m", "bold": "\033[1m",
        "underline": "\033[4m", "end": "\033[0m",
    }
    return "".join(colors[p] for p in prefix) + str(string) + colors["end"]

