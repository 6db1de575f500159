"""What the three probes share: timing by CUDA events, the card's name, the
published memory rate their numbers stand beside, and the command line."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from typing import Callable

import torch

# published peak of one H100 SXM (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12


def time_ms(fn: Callable[[], object], warmup: int = 2, reps: int = 5, inner: int = 3) -> float:
    """Median milliseconds of one call, by CUDA events around `inner` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "this probe needs a CUDA device (torch.cuda.is_available() is false); "
            "--device cpu runs its plain versions at a small size"
        )
    return dev


def main(run: Callable[..., dict], description: str) -> None:
    """Command line of a probe: `run(device=..., reps=...)`, printed as JSON."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=5, help="timed repetitions per setting")
    args = ap.parse_args()
    report = run(device=args.device, reps=args.reps)
    if torch.device(args.device).type == "cuda":
        report["card"] = card_line()
    print(json.dumps(report, indent=1))
