"""Fine-tune the stage-2 SoVITS synthesizer (VITS GAN recipe) with the
PyTorch port, on one CUDA card (``--device cpu`` for a dry run).

Counterpart of ``finetune_t2s_torch.py`` for the vocoder stage.  The RVQ
codebook stays frozen, so the fine-tuned model stays compatible with your
stage-1 GPT.  Training runs in float32, whatever the facade's dtype.

    python examples/finetune_sovits_torch.py --manifest data/train.list \
        --sovits s2Gv2ProPlus.pth --out-dir runs/s2_ft --steps 5000
"""
import argparse
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

    from gsv_tts_tpu_torch import TTS, train_data
    from gsv_tts_tpu_torch.train_loop import finetune_sovits

    tts = TTS(models_dir=args.models_dir, device=args.device)
    tts.load_sovits_model(args.sovits)
    sovits = tts.sovits_models[args.sovits]

    items = train_data.read_manifest(args.manifest)
    t0 = time.time()
    samples = train_data.featurize_sovits(tts, items)
    print(f"featurized {len(samples)} samples in {time.time() - t0:.1f}s")

    finetune_sovits(
        samples, sovits.cfg, sovits.hps, args.out_dir, total_steps=args.steps,
        batch_size=args.batch_size, init_params=sovits.params, device=tts.device,
        g_lr=args.g_lr, d_lr=args.d_lr, ckpt_every=args.ckpt_every,
        resume=not args.no_resume, max_steps_this_run=args.max_steps_this_run)
    print(f"saved fine-tuned SoVITS to {args.out_dir} — load with "
          f"TTS().load_sovits_model({args.out_dir!r})")


if __name__ == "__main__":
    main()
