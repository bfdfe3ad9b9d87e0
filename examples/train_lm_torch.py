"""Train a small LM for a few hundred steps with the full production loop
on the PyTorch port: prefetching data pipeline, AdamW, async
checkpointing, restart-exact resume, straggler flagging.  The same flow
as ``train_lm.py``, on ``repro_torch``: it runs on a CUDA card unless
``--device cpu`` is given (with no card, the default is an error).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--device cpu]
"""
import argparse
import dataclasses
import shutil
import tempfile

from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.transformer import OptFlags
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import TrainConfig, Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch).reduced(), n_layers=2)
    ckpt_dir = tempfile.mkdtemp(prefix="repro_train_")
    trainer = Trainer(
        cfg,
        opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=7),
        TrainConfig(steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir),
        flags=OptFlags(remat="dots", chunked_ce=True, ce_chunk=16),
        device=args.device,
    )
    print(f"training {cfg.name} (reduced) for {args.steps} steps; "
          f"checkpoints -> {ckpt_dir}")
    hist = trainer.train()
    for h in hist[:: max(1, len(hist) // 10)]:
        flag = " STRAGGLER" if h["straggler"] else ""
        print(f"step {h['step']:4d} loss {h['loss']:.4f} "
              f"({h['time_s'] * 1e3:.0f} ms){flag}")
    print(f"\nfinal loss {hist[-1]['loss']:.4f} "
          f"(from {hist[0]['loss']:.4f}); last checkpoint step "
          f"{trainer.checkpointer.last_committed}")

    # kill-and-restart demo: a fresh trainer resumes from the checkpoint
    t2 = Trainer(
        trainer.cfg,
        opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=7),
        TrainConfig(steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir),
        flags=OptFlags(remat="dots", chunked_ce=True, ce_chunk=16),
        device=args.device,
    )
    assert t2.maybe_restore()
    print(f"restart: resumed at step {t2.step} with data offset "
          f"{t2.pipeline.index} (restart-exact, see tests/test_train.py)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
