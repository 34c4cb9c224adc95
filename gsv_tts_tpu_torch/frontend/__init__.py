"""Text frontend (host code): language segmentation, text processing,
English and Chinese normalisation and G2P.

The English and Chinese subsets are this package's own copies of the modules
under ``gsv_tts_tpu/frontend`` (``lang_segment``, ``pause``,
``text_processor``, ``g2p/english``, ``g2p/en_norm``, ``g2p/en_oov``,
``g2p/en_pos``, ``g2p/chinese``, ``g2p/zh_norm``, ``g2p/tone_sandhi``), kept
verbatim; ``symbols.py`` reads this package's ``assets/symbols.json`` and
``g2p/__init__.py`` binds the dispatcher to this package's ``global_config``
and raises for Japanese, which is not ported yet.  Nothing here loads a file
of the JAX package.
"""
