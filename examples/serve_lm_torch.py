"""Batched serving with the selector+strap KV cache on the GPU — the
PyTorch port of `examples/serve_lm.py` (the same comparison, the same
output, the same final assertion).

Compares dense decode vs StrapCache exact mode (bit-identical greedy
stream) vs gated mode (top-k straps: the paper's C_BL-reduction analogue),
reporting tokens/s and HBM traffic.  On the card the strap backends
attend through the CUDA kernel `csrc/strap_attend.cu`.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--device cuda|cpu]

`--device` defaults to cuda and raises without a GPU; `--device cpu`
runs the plain PyTorch path.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.device import resolve_device
from repro_torch.memory.strap_cache import StrapCacheConfig
from repro_torch.models import registry as M
from repro_torch.serving.engine import ServeEngine

B, PROMPT, NEW = 4, 128, 16
MAX = PROMPT + NEW + 16


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("qwen2-1.5b-smoke")
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (B, PROMPT))

    print(f"batch={B}, prompt={PROMPT}, new_tokens={NEW}\n")
    results = {}
    for name, backend, top in (("dense", "dense", 0),
                               ("strap-exact", "strap", 0),
                               ("strap-gated(top4)", "strap", 4)):
        eng = ServeEngine(cfg, params, max_tokens=MAX, cache_backend=backend,
                          strap_cfg=StrapCacheConfig(page_size=16,
                                                     pages_per_strap=2,
                                                     top_straps=top),
                          device=dev)
        t0 = time.time()
        results[name] = eng.generate(prompts, NEW).cpu().numpy()
        dt = time.time() - t0
        line = f"{name:18s} {B * NEW / dt:7.1f} tok/s"
        if backend == "strap":
            line += (f"   HBM traffic vs dense: "
                     f"{100 * eng.stats.traffic_reduction:5.1f}%")
        print(line)

    exact_match = (results["dense"] == results["strap-exact"]).all()
    gated_match = (results["dense"] == results["strap-gated(top4)"]).mean()
    print(f"\nstrap-exact == dense: {bool(exact_match)} (bit-identical "
          f"greedy)")
    print(f"gated token agreement: {100 * gated_match:.0f}% "
          f"(untrained weights = worst case for the selector; trained models "
          f"concentrate attention mass within few straps)")
    assert exact_match
    return results


if __name__ == "__main__":
    main()
