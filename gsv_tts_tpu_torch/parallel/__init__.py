"""Training and multi-device execution (counterpart of ``gsv_tts_tpu/parallel/``):
``train`` (the t2s step, on one card or a mesh), ``mesh`` (``make_mesh``, the
tp layout, the collectives), ``shard`` (``DataParallelEngine``), ``pipeline``
(GPipe) and ``launch`` (a world of N processes on one host)."""
