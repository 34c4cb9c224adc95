"""Text frontend (host code): language segmentation, text processing,
English, Chinese and Japanese normalisation and G2P.

The English, Chinese and Japanese subsets are this package's own copies of
the modules under ``gsv_tts_tpu/frontend`` (``lang_segment``, ``pause``,
``text_processor``, ``g2p/english``, ``g2p/en_norm``, ``g2p/en_oov``,
``g2p/en_pos``, ``g2p/chinese``, ``g2p/zh_norm``, ``g2p/tone_sandhi``,
``g2p/japanese``), kept verbatim; ``symbols.py`` reads this package's
``assets/symbols.json`` and ``g2p/__init__.py`` binds the dispatcher to this
package's ``global_config`` (``ja`` takes ``JapaneseG2P``: kana only without
``pyopenjtalk``).  Nothing here loads a file of the JAX package.
"""
