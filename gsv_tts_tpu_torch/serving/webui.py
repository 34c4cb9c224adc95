"""Web UI: browser front-end for synthesis, voice conversion, presets,
rich-text multi-speaker scripts and history (counterpart of
``gsv_tts_tpu/serving/webui.py``, with its routes and page).

A dependency-free single page served with the REST API: rich-text scripts
(``<name>…</name>`` per-segment speaker presets and ``<break:1.5/>`` pauses,
parsed by :func:`parse_rich_text` and synthesized segment by segment), named
presets persisted as JSON in the work directory, a synthesis history with
replayable files, a model scan of the models directory, and post-FX: an RMS
loudness clamp by default, or the "enhance" chain of ``gsv_tts_tpu_torch.fx``.

The handlers are plain ``async`` methods returning ``serving.server.Reply``;
:func:`create_webui_app` puts them on an aiohttp app.
"""
from __future__ import annotations

import asyncio
import json
import re
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils.audio_io import save_wav
from .server import (HTTPError, Reply, file_reply, handler, json_reply, no_body, path_params,
                     text_reply)

_TAG_RE = re.compile(r"<([^/>][^>]*)>(.*?)</\1>|<break:([0-9.]+)\s*/>", re.S)


def parse_rich_text(text: str) -> List[Tuple[str, Any]]:
    """Split a script into segments: ('speak', (preset_name|None, text)) and
    ('break', seconds)."""
    out: List[Tuple[str, Any]] = []
    pos = 0
    for m in _TAG_RE.finditer(text):
        if m.start() > pos:
            chunk = text[pos: m.start()].strip()
            if chunk:
                out.append(("speak", (None, chunk)))
        if m.group(3) is not None:
            out.append(("break", float(m.group(3))))
        else:
            inner = m.group(2).strip()
            if inner:
                out.append(("speak", (m.group(1), inner)))
        pos = m.end()
    tail = text[pos:].strip()
    if tail:
        out.append(("speak", (None, tail)))
    return out


def loudness_normalize(audio: np.ndarray, target_rms: float = 0.1) -> np.ndarray:
    """Simple RMS-based loudness clamp (stand-in for pyloudnorm)."""
    rms = float(np.sqrt(np.mean(np.square(audio)))) if audio.size else 0.0
    if rms < 1e-6:
        return audio
    out = audio * (target_rms / rms)
    peak = np.abs(out).max()
    if peak > 0.99:
        out = out * (0.99 / peak)
    return out.astype(np.float32)


async def json_or_fail(request) -> dict:
    """The page's JSON body (a malformed one fails the request, as JAX's
    ``request.json()`` does)."""
    return await request.json()


class WebUI:
    def __init__(self, tts, workdir: Optional[Path] = None):
        self.tts = tts
        self.workdir = Path(workdir or (Path(tts.models_dir) / "webui"))
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.audio_dir = self.workdir / "audio"
        self.audio_dir.mkdir(exist_ok=True)
        self.presets_path = self.workdir / "presets.json"
        self.history_path = self.workdir / "history.json"

    # -- persistence -------------------------------------------------------

    def load_presets(self) -> Dict[str, dict]:
        if self.presets_path.exists():
            return json.loads(self.presets_path.read_text("utf-8"))
        return {}

    def save_presets(self, presets: Dict[str, dict]):
        self.presets_path.write_text(json.dumps(presets, ensure_ascii=False, indent=2),
                                     "utf-8")

    def append_history(self, entry: dict):
        hist = []
        if self.history_path.exists():
            hist = json.loads(self.history_path.read_text("utf-8"))
        hist.append(entry)
        self.history_path.write_text(json.dumps(hist[-200:], ensure_ascii=False), "utf-8")

    # -- synthesis ---------------------------------------------------------

    def synth_script(self, text: str, default_preset: dict, presets: Dict[str, dict],
                     params: dict) -> Tuple[np.ndarray, float, float]:
        """Synthesize a rich-text script; returns (audio, wall_s, rtf)."""
        t0 = time.perf_counter()
        pieces: List[np.ndarray] = []
        for kind, payload in parse_rich_text(text):
            if kind == "break":
                pieces.append(np.zeros(int(payload * self.tts.samplerate), np.float32))
                continue
            name, segment = payload
            preset = presets.get(name, default_preset) if name else default_preset
            spk = preset.get("speaker_audio") or preset["prompt_audio"]
            if isinstance(spk, dict):  # multi-speaker fusion weights
                spk = {k: float(v) for k, v in spk.items()}
            # executor threads serialize device work as the facade's own
            # *_async wrappers do
            with self.tts._infer_lock:
                clip = self.tts.infer(
                    spk_audio_path=spk,
                    prompt_audio_path=preset["prompt_audio"],
                    prompt_audio_text=preset["prompt_text"],
                    text=segment,
                    top_k=int(params.get("top_k", 15)),
                    top_p=float(params.get("top_p", 1.0)),
                    temperature=float(params.get("temperature", 1.0)),
                    repetition_penalty=float(params.get("repetition_penalty", 1.35)),
                    noise_scale=float(params.get("noise_scale", 0.5)),
                    speed=float(params.get("speed", 1.0)),
                )
            pieces.append(np.asarray(clip.audio_data, np.float32))
        audio = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
        if params.get("enhance", False) and audio.size:
            from ..fx import enhance_audio

            # the studio-polish chain, -18 LUFS normalization included
            audio = enhance_audio(audio, self.tts.samplerate)
        elif params.get("loudness_normalize", True):
            audio = loudness_normalize(audio)
        wall = time.perf_counter() - t0
        dur = len(audio) / self.tts.samplerate
        return audio, wall, (wall / dur if dur else float("inf"))

    # -- handlers ----------------------------------------------------------

    async def index(self, req=None) -> Reply:
        return text_reply(_INDEX_HTML, content_type="text/html")

    async def models(self, req=None) -> Reply:
        """Scan the models dir for checkpoints."""
        root = Path(self.tts.models_dir)
        found = {"gpt": [], "sovits": []}
        if root.exists():
            for p in root.rglob("*.ckpt"):
                if "eres2net" not in p.name:  # the SV checkpoint is a .ckpt
                    found["gpt"].append(str(p))
            for p in root.rglob("*.pth"):
                if "eres2net" not in p.name:
                    found["sovits"].append(str(p))
        found["gpt_loaded"] = [str(p) for p in self.tts.get_gpt_list()]
        found["sovits_loaded"] = [str(p) for p in self.tts.get_sovits_list()]
        return json_reply(found)

    async def presets(self, body: Optional[dict] = None) -> Reply:
        """``None`` (GET): the presets; a body (POST): save or delete one."""
        if body is None:
            return json_reply(self.load_presets())
        presets = self.load_presets()
        if body.get("delete"):
            presets.pop(body["name"], None)
        else:
            presets[body["name"]] = {
                "speaker_audio": body.get("speaker_audio"),
                "prompt_audio": body["prompt_audio"],
                "prompt_text": body["prompt_text"],
            }
        self.save_presets(presets)
        return json_reply({"ok": True, "presets": list(presets)})

    async def synth(self, body: dict) -> Reply:
        default_preset = {
            "speaker_audio": body.get("speaker_audio"),
            "prompt_audio": body["prompt_audio"],
            "prompt_text": body["prompt_text"],
        }
        audio, wall, rtf = await asyncio.get_running_loop().run_in_executor(
            None, lambda: self.synth_script(body["text"], default_preset,
                                            self.load_presets(), body))
        fname = f"ui_{uuid.uuid4().hex}.wav"
        save_wav(str(self.audio_dir / fname), audio, self.tts.samplerate)
        entry = {"text": body["text"], "file": fname, "rtf": round(rtf, 4),
                 "duration": round(len(audio) / self.tts.samplerate, 2),
                 "ts": time.time()}
        self.append_history(entry)
        return json_reply({"audio_url": f"/ui/audio/{fname}", **entry})

    async def vc(self, body: dict) -> Reply:
        def _vc_locked():
            with self.tts._infer_lock:
                return self.tts.infer_vc(
                    spk_audio_path=body["speaker_audio"],
                    prompt_audio_path=body["prompt_audio"],
                    prompt_audio_text=body["prompt_text"],
                    noise_scale=float(body.get("noise_scale", 0.5)),
                    speed=float(body.get("speed", 1.0)))

        clip = await asyncio.get_running_loop().run_in_executor(None, _vc_locked)
        fname = f"vc_{uuid.uuid4().hex}.wav"
        save_wav(str(self.audio_dir / fname), np.asarray(clip.audio_data), clip.samplerate)
        return json_reply({"audio_url": f"/ui/audio/{fname}", "duration": clip.audio_len_s})

    async def history(self, req=None) -> Reply:
        if self.history_path.exists():
            return json_reply(json.loads(self.history_path.read_text("utf-8")))
        return json_reply([])

    async def audio(self, req: dict) -> Reply:
        path = self.audio_dir / Path(req["filename"]).name
        if not path.exists():
            raise HTTPError(404, "404: Not Found")
        return file_reply(path)


def create_webui_app(tts, workdir=None):
    from .server import require_aiohttp

    web = require_aiohttp()
    ui = WebUI(tts, workdir)
    app = web.Application()
    app["webui"] = ui
    app.router.add_get("/", handler(ui.index, no_body))
    app.router.add_get("/ui/models", handler(ui.models, no_body))
    app.router.add_get("/ui/presets", handler(ui.presets, no_body))
    app.router.add_post("/ui/presets", handler(ui.presets, json_or_fail))
    app.router.add_post("/ui/synth", handler(ui.synth, json_or_fail))
    app.router.add_post("/ui/vc", handler(ui.vc, json_or_fail))
    app.router.add_get("/ui/history", handler(ui.history, no_body))
    app.router.add_get("/ui/audio/{filename}", handler(ui.audio, path_params))
    return app


_INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>GSV-TTS-Lite</title>
<style>
body{font-family:system-ui,sans-serif;max-width:880px;margin:2rem auto;padding:0 1rem;background:#fafafa}
h1{font-size:1.4rem} fieldset{border:1px solid #ddd;border-radius:8px;margin-bottom:1rem;background:#fff}
label{display:block;margin:.5rem 0 .15rem;font-size:.85rem;color:#444}
input,textarea,select{width:100%;box-sizing:border-box;padding:.4rem;border:1px solid #ccc;border-radius:4px}
button{padding:.5rem 1.2rem;border:0;border-radius:6px;background:#3b5bdb;color:#fff;cursor:pointer;margin-top:.6rem}
#hist li{font-size:.85rem;margin:.3rem 0} .row{display:flex;gap:1rem} .row>div{flex:1}
</style></head><body>
<h1>GSV-TTS-Lite <small>PyTorch / CUDA edition</small></h1>
<fieldset><legend>Synthesis</legend>
<label>Text (supports &lt;preset&gt;…&lt;/preset&gt; and &lt;break:1.5/&gt;)</label>
<textarea id="text" rows="4">Hello! This is the CUDA engine speaking.</textarea>
<div class="row">
<div><label>Speaker audio path</label><input id="spk"></div>
<div><label>Prompt audio path</label><input id="prompt"></div>
</div>
<label>Prompt text</label><input id="ptext">
<div class="row">
<div><label>top_k</label><input id="topk" value="15"></div>
<div><label>temperature</label><input id="temp" value="1.0"></div>
<div><label>speed</label><input id="speed" value="1.0"></div>
<div><label>noise</label><input id="noise" value="0.5"></div>
<div><label>enhance</label><input id="enhance" type="checkbox"></div>
</div>
<button onclick="synth()">Synthesize</button>
<div id="status"></div><audio id="player" controls style="width:100%;margin-top:.5rem"></audio>
</fieldset>
<fieldset><legend>Voice conversion</legend>
<div class="row">
<div><label>Target speaker audio</label><input id="vc_spk"></div>
<div><label>Source audio</label><input id="vc_src"></div>
</div>
<label>Source transcript</label><input id="vc_text">
<button onclick="vc()">Convert</button>
<audio id="vc_player" controls style="width:100%;margin-top:.5rem"></audio>
</fieldset>
<fieldset><legend>Presets</legend>
<div class="row">
<div><label>Name</label><input id="p_name"></div>
<div><label>Speaker audio</label><input id="p_spk"></div>
</div>
<div class="row">
<div><label>Prompt audio</label><input id="p_prompt"></div>
<div><label>Prompt text</label><input id="p_text"></div>
</div>
<button onclick="savePreset()">Save preset</button>
<div id="p_list"></div>
</fieldset>
<fieldset><legend>History</legend><ul id="hist"></ul></fieldset>
<script>
async function synth(){
  status.textContent='Synthesizing…';
  const body={text:text.value, speaker_audio:spk.value||null, prompt_audio:prompt.value,
              prompt_text:ptext.value, top_k:+topk.value, temperature:+temp.value,
              speed:+speed.value, noise_scale:+noise.value,
              enhance:enhance.checked};
  const r=await fetch('/ui/synth',{method:'POST',headers:{'Content-Type':'application/json'},body:JSON.stringify(body)});
  const d=await r.json();
  if(!r.ok){status.textContent='Error: '+JSON.stringify(d);return}
  status.textContent=`RTF ${d.rtf}, ${d.duration}s`;
  player.src=d.audio_url; player.play(); loadHist();
}
async function loadHist(){
  const h=await (await fetch('/ui/history')).json();
  const esc=s=>String(s).replace(/[&<>"']/g,c=>({'&':'&amp;','<':'&lt;','>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
  hist.innerHTML=h.slice(-12).reverse().map(e=>`<li><a href="/ui/audio/${esc(e.file)}">${esc(e.file)}</a> — ${esc(e.duration)}s, RTF ${esc(e.rtf)} — ${esc(e.text.slice(0,60))}</li>`).join('');
}
async function vc(){
  const r=await fetch('/ui/vc',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({speaker_audio:vc_spk.value, prompt_audio:vc_src.value, prompt_text:vc_text.value})});
  const d=await r.json();
  if(r.ok){vc_player.src=d.audio_url; vc_player.play();}
}
async function savePreset(){
  await fetch('/ui/presets',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({name:p_name.value, speaker_audio:p_spk.value,
                         prompt_audio:p_prompt.value, prompt_text:p_text.value})});
  loadPresets();
}
async function loadPresets(){
  const p=await (await fetch('/ui/presets')).json();
  p_list.textContent='Saved: '+Object.keys(p).join(', ');
}
loadHist(); loadPresets();
</script></body></html>
"""


def main(argv=None):
    import argparse

    from .server import DEVICE_HELP, create_app, engine_device, require_aiohttp

    ap = argparse.ArgumentParser(description="gsv-tts-lite Web UI on the PyTorch port")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9872)
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--gpt", default=None)
    ap.add_argument("--sovits", default=None)
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--quant-t2s", nargs="?", const="int8", default=False,
                    choices=("int8", "int4"),
                    help="quantized weight-streaming GPT decode (see the HTTP "
                         "server's flag of the same name)")
    ap.add_argument("--featurizer-buckets", action="store_true",
                    help="pad the BERT/HuBERT featurizer inputs to a ladder of "
                         "shapes (see the HTTP server's flag)")
    args = ap.parse_args(argv)

    web = require_aiohttp()
    from ..tts import TTS

    tts = TTS(models_dir=args.models_dir, device=engine_device(args.device), quant_t2s=args.quant_t2s,
              featurizer_buckets=args.featurizer_buckets)
    if args.gpt:
        tts.load_gpt_model(args.gpt)
    if args.sovits:
        tts.load_sovits_model(args.sovits)
    from ..utils.native import native_lib

    native_lib()  # the host DSP library builds now, not on the first enhance or stream request
    app = create_webui_app(tts)
    # mount the REST API under the same server
    app.add_subapp("/api/", create_app(tts))
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
