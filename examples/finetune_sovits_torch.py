"""Fine-tune the stage-2 SoVITS synthesizer (VITS GAN recipe) with the
PyTorch port, on one CUDA card or several (``--device cpu`` for a dry run).

Counterpart of ``finetune_t2s_torch.py`` for the vocoder stage.  The RVQ
codebook stays frozen, so the fine-tuned model stays compatible with your
stage-1 GPT.  Training runs in float32, whatever the facade's dtype.

    python examples/finetune_sovits_torch.py --manifest data/train.list \
        --sovits s2Gv2ProPlus.pth --out-dir runs/s2_ft --steps 5000

Under ``torchrun --nproc-per-node N`` each batch splits over the N ranks
(dp; ``--batch-size`` must divide by N), G and D replicated; rank 0
featurizes and sends the samples to the others, logs, checkpoints and
exports.
"""
import argparse
import os
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--sovits", required=True)
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--g-lr", type=float, default=1e-4)
    ap.add_argument("--d-lr", type=float, default=1e-4)
    ap.add_argument("--ckpt-every", type=int, default=500,
                    help="checkpoint cadence; interrupted runs resume from "
                         "{out-dir}/sovits_state.npz automatically")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore an existing checkpoint and start fresh")
    ap.add_argument("--max-steps-this-run", type=int, default=None)
    args = ap.parse_args()

    import torch.distributed as dist

    from gsv_tts_tpu_torch import TTS, train_data
    from gsv_tts_tpu_torch.parallel.mesh import make_mesh
    from gsv_tts_tpu_torch.train_loop import finetune_sovits

    world = int(os.environ.get("WORLD_SIZE", "1"))
    mesh = make_mesh(dp=world, tp=1, device=args.device) if world > 1 else None
    rank0 = mesh is None or dist.get_rank() == 0

    tts = TTS(models_dir=args.models_dir, device=args.device)
    tts.load_sovits_model(args.sovits)
    sovits = tts.sovits_models[args.sovits]

    samples = None
    if rank0:
        items = train_data.read_manifest(args.manifest)
        t0 = time.time()
        samples = train_data.featurize_sovits(tts, items)
        print(f"featurized {len(samples)} samples in {time.time() - t0:.1f}s")
    if mesh is not None:  # every rank trains on rank 0's samples
        box = [samples]
        dist.broadcast_object_list(box, src=0)
        samples = box[0]

    finetune_sovits(
        samples, sovits.cfg, sovits.hps, args.out_dir, total_steps=args.steps,
        batch_size=args.batch_size, init_params=sovits.params, device=tts.device,
        g_lr=args.g_lr, d_lr=args.d_lr, mesh=mesh, ckpt_every=args.ckpt_every,
        resume=not args.no_resume, max_steps_this_run=args.max_steps_this_run,
        log_fn=print if rank0 else lambda *_: None)
    if rank0:
        print(f"saved fine-tuned SoVITS to {args.out_dir} — load with "
              f"TTS().load_sovits_model({args.out_dir!r})")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
