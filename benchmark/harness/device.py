"""What the run says about the card: the cards it may use, and their name,
count and power limit."""

from __future__ import annotations

import shutil
import subprocess

import torch


def missing_cards(chips: int):
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false: the benchmark runs on an NVIDIA card only"
    if torch.cuda.device_count() < chips:
        return f"the cell asks for {chips} cards and torch.cuda.device_count() is {torch.cuda.device_count()}"
    return None


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or why not."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "power limit not read (no nvidia-smi)"
    res = subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = res.stdout.strip().splitlines()
    return lines[0] if res.returncode == 0 and lines else f"power limit not read (nvidia-smi exit {res.returncode})"
