"""A/B timer of the attention backward's f32 pair between source trees.

    python3 tools/ab_flash_bwd.py TREE [TREE ...]

Each TREE is a checkout of this repository (for instance the parent
commit unpacked with ``git archive`` under ``build/``); name them in the
order to run, such as ``A B B A``.  Every tree runs in a fresh process
that imports ``repro_torch`` from ``TREE/src`` (building its kernels
there), holds the f32 pair's gradients against the plain version
(``ref.chunked_bwd``) at float32 ``[2, 16, 2048, 64]`` and Qwen2.5-3B's
GQA group ``[2, 16/2, 2048, 128]``, causal, and prints one JSON line per
case: the largest error over the three gradients (of each one's largest
magnitude) and each backward kernel's device µs, the mean of 10 calls
under torch.profiler after 3 untimed ones.  Needs a CUDA card.
"""
import json
import subprocess
import sys

CASES = {"f32_d64": (2, 16, 16, 2048, 64),
         "f32_gqa128": (2, 16, 2, 2048, 128)}
ITERS = 10


def run_tree(tree: str) -> None:
    sys.path.insert(0, tree + "/src")
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr

    for name, (B, HQ, HKV, S, D) in CASES.items():
        g = torch.Generator(device="cuda").manual_seed(0)

        def view(H):   # [B, H, S, D] views of [B, S, H, D], as the model's
            return torch.randn((B, S, H, D), generator=g,
                               device="cuda").transpose(1, 2)
        q, k, v, do = view(HQ), view(HKV), view(HKV), view(HQ)
        o, lse = fk.flash_attention_lse(q, k, v)
        grads = fk.flash_attention_bwd(q, k, v, o, lse, do)
        plain = fr.chunked_bwd(q, k, v, o, lse, do, causal=True,
                               scale=D ** -0.5, q_chunk=512, k_chunk=1024)
        err = max(float((a - b).abs().max() / b.abs().max())
                  for a, b in zip(grads, plain))
        for _ in range(3):
            fk.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fk.flash_attention_bwd(q, k, v, o, lse, do)
            torch.cuda.synchronize()
        us: dict[str, float] = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and "flash_bwd" in e.name):
                key = e.name.split("<")[0].split()[-1]
                us[key] = us.get(key, 0.0) + e.time_range.elapsed_us() / ITERS
        print(json.dumps({"tree": tree, "case": name, "max_err": err,
                          "us": us}), flush=True)


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
