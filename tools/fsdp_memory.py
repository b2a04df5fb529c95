"""The 4D-STraG fine-tune's device memory per card under ``--mesh fsdp=N``,
by arithmetic from the port's configs (no card needed):

    python tools/fsdp_memory.py [--model_size 14b|1.3b] [--fsdp 4 8]

- the state: fp32 params, gradients, AdamW's two moments and the EMA, 20
  bytes a parameter of the 4D DiT (``config.dit_14b``/``dit_1_3b`` with
  motion guidance, in_dim 64, i2v; counted on the meta device), sharded
  over the fsdp ranks;
- the activations at batch 1 under the 'nothing' remat policy (every
  block rematerialised), 49 frames at 368x512 (9,568 tokens): each
  block's bf16 input kept for the backward, one block's working set while
  it runs again (q, k, v and o in bf16, the FFN's hidden and its GELU in
  bf16, six fp32 token-wide temporaries of the norms and modulation),
  twice for its gradients; and the block FSDP gathers whole, fp32, twice
  (the one that runs and the one gathered ahead) plus its fp32 gradient
  before the reduce-scatter.

The activation terms are an estimate from these shapes; the card
measures the 1.3B's in ``chip_smoke.py`` (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

TOKENS = 13 * 23 * 32        # 49 frames at 368x512: 13 x 23 x 32 patches


def dit_memory(model_size: str, fsdp: int, tokens: int = TOKENS) -> dict:
    import torch

    from more4d_tpu_torch.config import dit_1_3b, dit_14b
    from more4d_tpu_torch.models import WanDiT

    make = dit_14b if model_size == "14b" else dit_1_3b
    cfg = make(motion_guidance=True, in_dim=64, model_type="i2v")
    with torch.device("meta"):
        dit = WanDiT(cfg)
    params = sum(p.numel() for p in dit.parameters())
    block = sum(p.numel() for p in dit.blocks[0].parameters())
    gib = 2.0 ** 30
    state = 20.0 * params / fsdp
    inputs = cfg.num_layers * tokens * cfg.dim * 2
    working = 2 * tokens * (5 * cfg.dim * 2 + 2 * cfg.ffn_dim * 2
                            + 6 * cfg.dim * 4)
    gathered = 3 * block * 4 if fsdp > 1 else 0
    total = state + inputs + working + gathered
    return {"model_size": model_size, "fsdp": fsdp, "params": params,
            "block_params": block, "state_gib": state / gib,
            "block_inputs_gib": inputs / gib,
            "block_working_set_gib": working / gib,
            "gathered_block_gib": gathered / gib, "total_gib": total / gib}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model_size", default="14b", choices=["14b", "1.3b"])
    p.add_argument("--fsdp", type=int, nargs="+", default=[4, 8])
    args = p.parse_args(argv)
    for n in args.fsdp:
        print(json.dumps(dit_memory(args.model_size, n)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
