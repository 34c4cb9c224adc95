"""Training on one card (counterpart of ``gsv_tts_tpu/parallel/``; its meshes are
not ported yet)."""
