"""First touch of a fresh blocked output on the host of the card.

    python perf_records/prefault_ab.py

At the blocked 1080p cell's shapes (a 256x1080x1920x3 f32 output, 6.37 GB,
drained in 64-frame render blocks of 1.59 GB) it times, three times each:
one pinned block copied into a fresh `np.empty` and into one already
touched; `vstab_torch.pipeline_blocked._Prefault` over the whole output with
1 and with 4 threads; the four blocks copied into a fresh output and into
one the helper faulted in. It prints the host's CPU count, its transparent
huge page setting and the card's name and power limit, and sets nothing.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vstab_torch import pipeline_blocked as pb  # noqa: E402

T, B, H, W = 256, 64, 1080, 1920
REPS = 3


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError as e:
        return f"unreadable ({e})"


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"no nvidia-smi ({e})"


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _prefault(out: np.ndarray) -> None:
    with pb._Prefault(out, B) as pf:
        for start, _ in pf.slices:
            pf.wait(start)


def main() -> None:
    print(f"cpu_count {os.cpu_count()}; sched_getaffinity {len(os.sched_getaffinity(0))}")
    print(f"transparent_hugepage/enabled: {_read('/sys/kernel/mm/transparent_hugepage/enabled')}")
    print(f"transparent_hugepage/defrag: {_read('/sys/kernel/mm/transparent_hugepage/defrag')}")
    print(f"card: {_card()}; torch {torch.__version__}; numpy {np.__version__}")
    print(f"page size {os.sysconf('SC_PAGE_SIZE')}; _PREFAULT_THREADS {pb._PREFAULT_THREADS}")

    pinned = torch.cuda.is_available()
    blk_t = torch.empty((B, H, W, 3), dtype=torch.float32, pin_memory=pinned).fill_(0.5)
    blk = blk_t.numpy()
    print(f"block {blk.nbytes / 1e9:.3f} GB, pinned {pinned}; output {T * blk.nbytes / B / 1e9:.3f} GB")

    for rep in range(REPS):
        fresh = np.empty_like(blk)
        s_fresh = _timed(lambda: np.copyto(fresh, blk))
        del fresh
        touched = np.empty_like(blk)
        np.copyto(touched, blk)
        s_touched = _timed(lambda: np.copyto(touched, blk))
        del touched
        print(f"block copy, rep {rep}: fresh {s_fresh:.4f} s, touched {s_touched:.4f} s")

    for n in (1, 4) * REPS:
        pb._PREFAULT_THREADS = n
        out = np.empty((T, H, W, 3), np.float32)
        print(f"helper, {n} thread(s): {_timed(lambda: _prefault(out)):.4f} s for {out.nbytes / 1e9:.3f} GB")
        del out
    pb._PREFAULT_THREADS = max(1, min(4, (os.cpu_count() or 1) - 1))

    def drain(out):
        for start in range(0, T, B):
            out[start : start + B] = blk

    for rep in range(REPS):
        out = np.empty((T, H, W, 3), np.float32)
        s_fresh = _timed(lambda: drain(out))
        del out
        out = np.empty((T, H, W, 3), np.float32)
        s_fault = _timed(lambda: _prefault(out))
        s_resident = _timed(lambda: drain(out))
        del out
        print(f"four-block drain, rep {rep}: fresh {s_fresh:.4f} s; helper ({pb._PREFAULT_THREADS} threads) "
              f"{s_fault:.4f} s then drain {s_resident:.4f} s")


if __name__ == "__main__":
    main()
