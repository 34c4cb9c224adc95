"""The run refuses to report while JAX or the JAX package is loaded."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "gsv_tts_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``gsv_tts_tpu_torch`` is the program and allowed)."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def no_outside_connections():
    """Refuse any socket connect to a host other than this one: the
    benchmark runs offline, and nothing it drives may reach out."""
    def hook(event, args):
        if event == "socket.connect" and len(args) > 1:
            addr = args[1]
            host = addr[0] if isinstance(addr, tuple) and addr else addr
            if isinstance(host, str) and host not in ("127.0.0.1", "localhost", "::1", ""):
                raise ConnectionRefusedError(f"benchmark runs offline: connect to {host!r}")
    sys.addaudithook(hook)
