"""Device selection and build locations shared by the port's entry points."""

from __future__ import annotations

import fcntl
import os
import subprocess
from contextlib import contextmanager
from typing import Iterator, List, Optional, Union

import torch

__all__ = ["resolve_device", "build_dir", "run_locked_build"]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. It defaults to the card and never
    falls back silently: asking for CUDA where there is none raises; the
    CPU is used only when the caller names it (as the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def build_dir(name: str) -> str:
    """``build/<name>`` under the checkout root (listed in .gitignore)."""
    path = os.path.join(_REPO_ROOT, "build", name)
    os.makedirs(path, exist_ok=True)
    return path


@contextmanager
def _file_lock(path: str) -> Iterator[None]:
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def run_locked_build(out: str, cmd: List[str], log: Optional[str] = None) -> str:
    """Run ``cmd`` to produce ``out`` unless it exists, holding a lock in
    ``out``'s directory so concurrent first users build once. The build's
    output goes into the error raised when it fails, and into ``log`` (when
    given) either way."""
    if os.path.exists(out):
        return out
    with _file_lock(os.path.join(os.path.dirname(out), ".build.lock")):
        if not os.path.exists(out):
            proc = subprocess.run(cmd, cwd=_REPO_ROOT, capture_output=True, text=True)
            if log is not None:
                with open(log, "w") as f:
                    f.write(proc.stdout + proc.stderr)
            if proc.returncode != 0 or not os.path.exists(out):
                raise RuntimeError(
                    f"build of {out} failed (rc={proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
                )
    return out
