#!/usr/bin/env python3
"""Whether ``chip_smoke.py``'s model-serve gates catch a wrong kernel: the
granite-moe-3b-a800m phase (``chip_smoke.model_phase``: full width, batch
4, 2048-token prompts, 16 tokens, two serves, the plain path
teacher-forced) run once as it is and once with each planted fault in
the kernel path's ``rmsnorm_2d`` outputs.  The plain path
(``dispatch.use_backend("ref")``) is left as it is.

    python3 tools/torch_model_gates.py

Plants (each deterministic, so the two serves still agree bit for bit):

  * ``none``: the kernel as it is; every gate must pass;
  * ``ulp``: every output element moved up or down (a fixed random sign
    a shape) by ``(1 +- 2**-8)`` and rounded back to bfloat16, about one
    bfloat16 ulp: the size of error the logits envelope assumes at each
    rounding site;
  * ``tail``: the last element of every row set to zero, a row tail the
    kernel never wrote.

Prints the card's name and power limit, one JSON line a plant (whether
the phase passed, the gates that failed and, when it passed, the
logits' relative RMS and the near-tie rows), and last a JSON line with
every plant's verdict.  Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PLANTS = ("none", "ulp", "tail")


def planted(kernel, plant: str):
    """``kernel`` (``rmsnorm_2d``) with ``plant`` applied to its output."""
    signs = {}

    def run(x, gain, **kw):
        out = kernel(x, gain, **kw)
        if plant == "ulp":
            key = (tuple(out.shape), out.device)
            if key not in signs:
                g = torch.Generator(device=out.device).manual_seed(out.numel())
                signs[key] = torch.randint(0, 2, out.shape, generator=g,
                                           device=out.device) * 2 - 1
            out = (out.float() * (1 + signs[key] * 2.0 ** -8)).to(out.dtype)
        elif plant == "tail":
            out = out.clone()
            out[:, -1] = 0
        return out
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_model_gates: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs._build.build_all()
    kernel = cs.rms_k.rmsnorm_2d
    verdicts = {}
    for plant in PLANTS:
        cs.rms_k.rmsnorm_2d = planted(kernel, plant)
        try:
            _, _, s = cs.model_phase(cs.configs.get(cs.GRANITE_ARCH))
            row = {"plant": plant, "passed": True,
                   "logits_rel_rms_max": s["logits_rel_rms_max"],
                   "logits_rtol": s["logits_rtol"],
                   "tokens_differing": len(s["tokens_differing"]),
                   "near_tie_rows": s["near_tie_rows"]}
        except SystemExit as e:
            msg = str(e).split(": ", 1)[-1]
            gates = [g.split(": ")[0] for g in msg.split("; ")]
            row = {"plant": plant, "passed": False, "failed": gates,
                   "message": str(e)[:2000]}
        finally:
            cs.rms_k.rmsnorm_2d = kernel
        torch.cuda.empty_cache()
        verdicts[plant] = row["passed"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"card": cs.card_line(), "passed": verdicts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
