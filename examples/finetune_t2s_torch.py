"""Fine-tune the stage-1 (text→semantic) decoder on your own recordings with
the PyTorch port, on one CUDA card or several (``--device cpu`` for a dry run).

  1. featurize (wav, text) pairs with the frontend / HuBERT / RVQ stack
     inference uses (``gsv_tts_tpu_torch/train_data.py``),
  2. teacher-forced next-token CE over the audio block, AdamW with
     warmup-cosine and global-norm clipping (``gsv_tts_tpu_torch/parallel/train.py``),
  3. export a safetensors checkpoint directory ``TTS.load_gpt_model`` reads.

Manifest format (``--manifest``): the upstream GPT-SoVITS ``.list`` lines
``wav_path|speaker|lang|text`` or ``.jsonl`` ``{"wav", "text", "lang"}``.

    python examples/finetune_t2s_torch.py --manifest data/train.list \
        --gpt s1v3.ckpt --sovits s2Gv2ProPlus.pth --out-dir runs/ft \
        --steps 2000 --batch-size 8

Over N cards, one process each: ``torchrun`` starts the world and the script
trains over a mesh of all of it — ``("dp", "tp")`` (tp the first of 4, 2, 1
that divides N), or with ``--pp`` a ``("dp", "pp")`` GPipe mesh of ``--pp``
stages and ``--n-micro`` microbatches.  Rank 0 featurizes and sends the
samples to the others, logs, checkpoints and exports:

    torchrun --nproc-per-node 2 examples/finetune_t2s_torch.py --pp 2 ...
"""
import argparse
import os
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--gpt", required=True, help=".ckpt / safetensors dir to start from")
    ap.add_argument("--sovits", required=True, help="SoVITS weights (RVQ codebook for targets)")
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--remat", action="store_true",
                    help="recompute the forward in the backward pass (less activation memory)")
    ap.add_argument("--cache", default=None,
                    help="featurized-sample .npz cache (skips re-extraction)")
    ap.add_argument("--ckpt-every", type=int, default=500,
                    help="checkpoint cadence; interrupted runs resume from "
                         "{out-dir}/t2s_state.npz automatically")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore an existing checkpoint and start fresh")
    ap.add_argument("--pp", type=int, default=0,
                    help="pipeline stages (GPipe over a ('dp','pp') mesh of the world; "
                         "0: a ('dp','tp') mesh when the world has more than one rank)")
    ap.add_argument("--n-micro", type=int, default=2,
                    help="GPipe microbatches per step (with --pp)")
    ap.add_argument("--max-steps-this-run", type=int, default=None,
                    help="stop after N steps this invocation (time-boxed jobs); "
                         "--steps still shapes the schedule")
    args = ap.parse_args()

    import torch.distributed as dist

    from gsv_tts_tpu_torch import TTS, train_data
    from gsv_tts_tpu_torch.parallel.mesh import make_mesh
    from gsv_tts_tpu_torch.parallel.pipeline import make_mesh_dp_pp
    from gsv_tts_tpu_torch.train_loop import finetune_t2s

    mesh = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or args.pp > 1:
        # before the facade: each rank takes its own card here
        mesh = make_mesh_dp_pp(pp=args.pp, device=args.device) if args.pp > 1 \
            else make_mesh(device=args.device)
    rank0 = mesh is None or dist.get_rank() == 0
    if mesh is not None and rank0:
        print(f"training over {dist.get_world_size()} ranks: mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}")

    tts = TTS(models_dir=args.models_dir, device=args.device)
    tts.load_gpt_model(args.gpt)
    gpt = tts.gpt_models[args.gpt]

    samples = None
    if rank0:
        if args.cache and Path(args.cache).exists():
            samples = train_data.load_samples(args.cache)
            print(f"loaded {len(samples)} cached samples from {args.cache}")
        else:
            tts.load_sovits_model(args.sovits)
            items = train_data.read_manifest(args.manifest)
            t0 = time.time()
            samples = train_data.featurize(tts, items)
            print(f"featurized {len(samples)} samples in {time.time() - t0:.1f}s")
            if args.cache:
                train_data.save_samples(args.cache, samples)
    if mesh is not None:  # every rank trains on rank 0's samples
        box = [samples]
        dist.broadcast_object_list(box, src=0)
        samples = box[0]

    finetune_t2s(
        samples, gpt.cfg, args.out_dir, total_steps=args.steps, batch_size=args.batch_size,
        init_params=gpt.params, device=tts.device, dtype=tts.tts_config.dtype,
        peak_lr=args.lr, warmup_steps=args.warmup, remat=args.remat, mesh=mesh,
        pp_n_micro=args.n_micro, ckpt_every=args.ckpt_every, resume=not args.no_resume,
        max_steps_this_run=args.max_steps_this_run, log_fn=print if rank0 else lambda *_: None)
    if rank0:
        print(f"saved fine-tuned checkpoint to {args.out_dir} — load with "
              f"TTS().load_gpt_model({args.out_dir!r})")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
