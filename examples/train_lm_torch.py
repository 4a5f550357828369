"""End-to-end training driver on the PyTorch / H100 port: a ~100M-param
qwen3-family model for a few hundred steps on the synthetic pipeline, with
checkpoints and restart (``examples/train_lm.py``'s run).

The defaults keep this small (--layers 4 --d-model 256 ...); the bundle is
handed to ``repro_torch.launch.train.run`` as it is, so no registry entry
is needed.  On the card the model trains in bf16 through the flash
kernels; ``--device cpu`` trains in f32 on the plain versions.

Run:  PYTHONPATH=src python examples/train_lm_torch.py --steps 200 \\
          [--device cpu]
"""
import argparse
import tempfile

import torch

from repro_torch.configs.base import ArchBundle
from repro_torch.device import resolve_device
from repro_torch.launch.train import run
from repro_torch.models import TransformerConfig, transformer


def bundle_100m(layers, d_model, heads, kv, d_ff, vocab, dtype):
    cfg = TransformerConfig(
        name="train-lm-100m", n_layers=layers, d_model=d_model,
        n_heads=heads, n_kv_heads=kv, d_ff=d_ff, vocab=vocab, qk_norm=True,
        dtype=dtype)
    return ArchBundle("train-lm-100m", "dense", cfg, transformer)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary "
                         "one)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    b = bundle_100m(a.layers, a.d_model, max(4, a.d_model // 64),
                    max(2, a.d_model // 128), a.d_model * 4, 8192, dtype)
    print(f"model: {b.param_count()/1e6:.1f}M params, {dtype} on {dev}")
    ckpt_dir = a.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_lm_")
    out = run(b, steps=a.steps, seq_len=a.seq_len,
              global_batch=a.global_batch, ckpt_dir=ckpt_dir,
              ckpt_every=50, lr=1e-3, log_every=10, device=dev)
    losses = out["losses"]
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"over {len(losses)} steps")
    assert losses[-1] < losses[0], "training failed to reduce loss"


if __name__ == "__main__":
    main()
