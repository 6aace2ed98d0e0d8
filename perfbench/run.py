"""Run one cell of the benchmark from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is the result (see `harness`).  The
program under test is `src/repro_torch`; its kernel builds land in
`build/` inside the checkout.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the checkout's root and its `src`, not this folder: its module names
# must not shadow the standard library's
sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]
# any build or kernel cache stays inside the checkout, at a fixed path
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / sub)

# one thread a host library: PyTorch's CPU operations and numpy's BLAS
# would otherwise each start a worker a core, which run the plan no faster
# and, on a host whose cores other work shares, spread the host-bound
# cells' rates two to three times as widely
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"


def pin_allocator() -> None:
    """Fix glibc's mmap threshold at the largest value its dynamic
    threshold climbs to, and its trim threshold at 1 GiB, before the
    program allocates.  Left to glibc, a
    process frees and faults back the host plan's arrays at one of two
    paces, by its allocation history alone (the sweep's plan 58-67 or
    103-157 ms on the same host); pinned, every run starts in the same
    state.  Without glibc this does nothing."""
    import ctypes
    import ctypes.util

    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    mallopt(m_mmap_threshold, 32 << 20)      # glibc's largest dynamic value
    mallopt(m_trim_threshold, 1 << 30)


pin_allocator()

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
