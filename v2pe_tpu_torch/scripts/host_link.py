"""The card's host side, which the offloaded optimizer and checkpoints use:
host memory, free disk beside the checkout, the time to pin host memory,
the rate of pinned copies each way, and the disk's write rate.

    python -m v2pe_tpu_torch.scripts.host_link [--pin-gib 16] [--disk-gib 8]

Every line names the card and its power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import torch

from v2pe_tpu_torch.scripts._card import card


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pin-gib", type=int, default=16,
                    help="pinned host memory to allocate and time")
    ap.add_argument("--disk-gib", type=int, default=8,
                    help="bytes written (with fsync) to time the disk")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("host_link: no CUDA device")
    where = card("cuda")
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    here = os.path.dirname(os.path.abspath(__file__))
    print(f"host memory {host / 2 ** 30:.1f} GiB; disk free beside the "
          f"checkout {shutil.disk_usage(here).free / 1e9:.1f} GB ({where})")
    t0 = time.perf_counter()
    pinned = torch.empty(args.pin_gib * 2 ** 30, dtype=torch.int8,
                         pin_memory=True)
    print(f"pinning {args.pin_gib} GiB: {time.perf_counter() - t0:.2f} s "
          f"({where})")
    n = 2 ** 30
    dev = torch.empty(n, dtype=torch.int8, device="cuda")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev.copy_(pinned[:n], non_blocking=True)
        torch.cuda.synchronize()
        up = time.perf_counter() - t0
        t0 = time.perf_counter()
        pinned[:n].copy_(dev, non_blocking=True)
        torch.cuda.synchronize()
        down = time.perf_counter() - t0
        print(f"1 GiB pinned copy: host to card {n / up / 1e9:.1f} GB/s, "
              f"card to host {n / down / 1e9:.1f} GB/s ({where})")
    del pinned, dev
    block = os.urandom(2 ** 20) * 64  # 64 MiB
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "write_test")
        t0 = time.perf_counter()
        with open(path, "wb") as f:
            for _ in range(args.disk_gib * 16):
                f.write(block)
            f.flush()
            os.fsync(f.fileno())
        secs = time.perf_counter() - t0
    print(f"disk: {args.disk_gib} GiB written with fsync at "
          f"{args.disk_gib * 2 ** 30 / secs / 1e6:.0f} MB/s ({where})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
