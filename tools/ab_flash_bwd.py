"""A/B timer of the attention kernels' f32 routes and of delta between
source trees.

    python3 tools/ab_flash_bwd.py TREE [TREE ...]

Each TREE is a checkout of this repository (for instance the parent
commit unpacked with ``git archive`` under ``build/``); name them in the
order to run, such as ``A B B A``.  Every tree runs in a fresh process
that imports ``repro_torch`` from ``TREE/src`` (building its kernels
there) and prints one JSON line per case: each matching kernel's device
µs a launch, the mean over the launches torch.profiler kept of 10 calls
after 3 untimed ones, and the case's largest error:

- ``f32_d64``, ``f32_gqa128``: the backward's f32 pair at float32 ``[2,
  16, 2048, 64]`` and Qwen2.5-3B's GQA group ``[2, 16/2, 2048, 128]``,
  causal; the error over the three gradients against the plain version
  (``ref.chunked_bwd``), of each one's largest magnitude;
- ``fwd_f32_gqa128``, ``fwd_f32_d64``: the forward's f32 route
  (``flash_fwd_kernel``) at the same two shapes; the absolute error
  against ``ref.flash_attention_ref``;
- ``delta_train``, ``delta_f32``: delta (``flash_bwd_delta_kernel``,
  timed inside ``flash_attention_bwd``, which every tree has) at the
  training shape, bf16 ``[4, 16, 4096, 64]``, and at float32 ``[2, 16,
  2048, 64]``; the error against ``(do.float() * o.float()).sum(-1)``
  of its largest magnitude, where the tree has ``flash_bwd_delta``.

Needs a CUDA card.
"""
import json
import subprocess
import sys

# (B, HQ, HKV, S, D, dtype)
BWD = {"f32_d64": (2, 16, 16, 2048, 64, "float32"),
       "f32_gqa128": (2, 16, 2, 2048, 128, "float32")}
FWD = {"fwd_f32_gqa128": (2, 16, 2, 2048, 128, "float32"),
       "fwd_f32_d64": (2, 16, 16, 2048, 64, "float32")}
DELTA = {"delta_train": (4, 16, 16, 4096, 64, "bfloat16"),
         "delta_f32": (2, 16, 16, 2048, 64, "float32")}
ITERS = 10


def device_us(fn, name: str) -> dict:
    """Device µs a launch of each kernel whose name holds ``name``, over
    ITERS calls of ``fn``: the mean over the launches the profiler kept
    (a window may lose a record)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    us: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name:
            key = e.name[e.name.index(name):].split("(")[0]
            us.setdefault(key, []).append(e.time_range.elapsed_us())
    return {k: sum(v) / len(v) for k, v in us.items()}


def run_tree(tree: str) -> None:
    sys.path.insert(0, tree + "/src")
    import torch

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr

    def views(B, HQ, HKV, S, D, dtype):
        g = torch.Generator(device="cuda").manual_seed(0)

        def view(H):   # [B, H, S, D] views of [B, S, H, D], as the model's
            return torch.randn((B, S, H, D), generator=g, device="cuda").to(
                getattr(torch, dtype)).transpose(1, 2)
        return view(HQ), view(HKV), view(HKV), view(HQ)

    def emit(case, err, us):
        print(json.dumps({"tree": tree, "case": case, "max_err": err,
                          "us": us}), flush=True)

    for name, shape in BWD.items():
        q, k, v, do = views(*shape)
        o, lse = fk.flash_attention_lse(q, k, v)
        grads = fk.flash_attention_bwd(q, k, v, o, lse, do)
        plain = fr.chunked_bwd(q, k, v, o, lse, do, causal=True,
                               scale=shape[4] ** -0.5, q_chunk=512,
                               k_chunk=1024)
        emit(name, max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(grads, plain)),
             device_us(lambda: fk.flash_attention_bwd(q, k, v, o, lse, do),
                       "flash_bwd"))
    for name, shape in FWD.items():
        q, k, v, _ = views(*shape)
        got = fk.flash_attention(q, k, v)
        emit(name, float((got - fr.flash_attention_ref(q, k, v)).abs().max()),
             device_us(lambda: fk.flash_attention(q, k, v),
                       "flash_fwd_kernel"))
    for name, shape in DELTA.items():
        q, k, v, do = views(*shape)
        o, lse = fk.flash_attention_lse(q, k, v)
        exp = (do.float() * o.float()).sum(-1)
        err = None
        if hasattr(fk, "flash_bwd_delta"):
            err = float((fk.flash_bwd_delta(o, do) - exp).abs().max()
                        / exp.abs().max())
        emit(name, err, device_us(lambda: fk.flash_attention_bwd(
            q, k, v, o, lse, do), "flash_bwd_delta"))


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        run_tree(argv[1])
        return 0
    if not argv:
        sys.exit(__doc__)
    for tree in argv:
        rc = subprocess.run([sys.executable, __file__, "--one", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
