"""What the benchmark keeps of the requests it will judge.

For a greedy request the recorder wraps, on the loaded models, the t2s
engine's ``generate`` (its inputs and the served codes) and the engine
module's ``prefill_batch`` (the code sampled at the prefill, which
``infer`` feeds but does not serve); the configuration's SoVITS family
(``families/<name>.py``) wraps what it judges of the SoVITS stage and keeps
it in the item's ``"sovits"`` list.  Nothing is read back from the card
while a request runs: tensors are kept and read after the window.  Only
requests marked with :meth:`want` are recorded.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class Recorder:
    def __init__(self):
        self.items: List[dict] = []
        self._cur: Optional[dict] = None
        self._undo = []
        #: (phonemes, prompt codes) of the last ``generate`` call, recorded or not
        self.last_lens = None

    def want(self, item: Optional[dict]):
        """Record the next calls into ``item`` (None: nothing)."""
        self._cur = item
        if item is not None:
            item.setdefault("gen", [])
            item.setdefault("sovits", [])
            self.items.append(item)

    def _patch(self, obj, name, wrapper):
        orig = getattr(obj, name)
        setattr(obj, name, wrapper(orig))
        self._undo.append((obj, name, orig))

    def install(self, tts, engine, family):
        from gsv_tts_tpu_torch.runtime import t2s_session

        rec = self

        def gen_wrap(orig):
            def generate(x_ids, y_ids, bert, *a, **kw):
                rec.last_lens = (int(np.size(x_ids)), int(np.size(y_ids)))
                cur = rec._cur
                if cur is not None:
                    g = {"x": np.asarray(x_ids, np.int64).reshape(-1).copy(),
                         "y": np.asarray(y_ids, np.int64).reshape(-1).copy(),
                         "bert": np.asarray(bert, np.float32).copy(), "tok0": []}
                    cur["gen"].append(g)
                    cur["_g"] = g
                out = orig(x_ids, y_ids, bert, *a, **kw)
                if cur is not None:
                    g["served"] = np.asarray(out, np.int64).reshape(-1).copy()
                    cur["_g"] = None
                return out
            return generate

        def prefill_wrap(orig):
            def prefill_batch(*a, **kw):
                state, tok = orig(*a, **kw)
                cur = rec._cur
                if cur is not None and cur.get("_g") is not None:
                    cur["_g"]["tok0"].append(tok.detach().clone())
                return state, tok
            return prefill_batch

        self._patch(engine, "generate", gen_wrap)
        self._patch(t2s_session, "prefill_batch", prefill_wrap)
        family.install(self, tts)

    def uninstall(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo.clear()

    def finish(self):
        """Bring the kept tensors to the host (after the window)."""
        for item in self.items:
            item.pop("_g", None)
            for g in item["gen"]:
                g["tok0"] = [int(t.reshape(-1)[0]) for t in g["tok0"]]
