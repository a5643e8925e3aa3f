"""Time the MaxSim kernels alone, with no correctness check: the burst
time (CUDA events over 50 back-to-back calls, the card held while the host
queues them) of `ops.maxsim.maxsim_rescore` at the served ColBERTv2 shape
(N_pad 131,072, cap 256, D 128, W 64, Tq 32) for int8 and int4 tiles at
Q=256 and Q=1. For comparing builds of `csrc/maxsim.cu` side by side: copy
the package and `chip_smoke.py` into a directory a variant, edit the copy,
and run from each directory in one session on the card:

    cd <copy> && python3 /path/to/chip_probes/maxsim_timer.py <label>

Prints one line: the label and the four times in ms. Needs a CUDA card.
"""
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())      # the checkout or copy it runs in
import chip_smoke as cs  # noqa: E402
from elasticsearch_tpu_torch.ops import _build, maxsim  # noqa: E402


def main(label: str) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("maxsim_timer: no CUDA device available")
    _build.build(["maxsim"])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    counts = torch.from_numpy(cs.colbert_counts(
        np.random.default_rng(5), (1 << 17) - 1)).to(dev)
    out = []
    for dtype in (torch.int8, torch.uint8):
        toks, scales = cs._token_tile(g, dev, dtype, counts, 1 << 17, 256,
                                      128)
        for nq in (256, 1):
            q = torch.randn(nq, 32, 128, generator=g, device=dev)
            ids = torch.randint(0, len(counts), (nq, 64), generator=g,
                                device=dev, dtype=torch.int32)
            ms = cs.burst_ms(lambda: maxsim.maxsim_rescore(ids, q, toks,
                                                           scales))
            out.append(f"{str(dtype)[6:]} Q={nq} {ms:.5f}")
        del toks, scales
    print(label, " | ".join(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "maxsim")
