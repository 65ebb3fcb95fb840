"""What the scripts share: the ``--device`` / ``--out-dir`` arguments,
the refusal of a card run without CUDA, and the hardware label."""

from __future__ import annotations

import os
import subprocess
import sys

import torch

#: The checkout's root; the scripts' default output lies under it.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(ROOT, "results", "h100")


def add_device_args(parser) -> None:
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where to run (default: cuda)")
    parser.add_argument("--out-dir", default=RESULTS_DIR,
                        help="where the results go (default: "
                             "results/h100/ of the checkout)")


def device_error(device: str):
    """The message that stops a card run without CUDA, else None."""
    if device == "cuda" and not torch.cuda.is_available():
        return ("--device cuda needs a CUDA device, and "
                "torch.cuda.is_available() is False; pass --device cpu to "
                "run on the CPU")
    return None


def refuse(prog: str, message: str) -> int:
    print(f"{prog}: error: {message}", file=sys.stderr)
    return 1


def tag(device: str) -> str:
    """The file-name tag of a run's results: ``h100`` on the card,
    ``cpu`` on the CPU."""
    return "h100" if device == "cuda" else "cpu"


def hardware(device: str) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them
    (``torch.cuda.get_device_name`` where it cannot be read), or
    ``"cpu"``."""
    if device != "cuda":
        return "cpu"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(torch.cuda.current_device())],
            capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name()} (power limit not read)"


def has_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True
