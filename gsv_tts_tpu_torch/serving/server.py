"""HTTP serving layer: SSE streaming, batched synthesis and the GPT-SoVITS
api_v2 surface over the port's facade (counterpart of
``gsv_tts_tpu/serving/server.py``, with its routes, statuses and bodies):

  GET  /                      – service info
  POST /tts/stream            – SSE: base64 audio chunks + subtitles
  POST /tts/stream/batched    – SSE of a continuous-batched call
  POST /tts/batched           – batched synthesis, JSON with file refs
  GET  /audio/{filename}      – serve generated files
  GET/POST /tts               – GPT-SoVITS api_v2 compatibility
  GET  /set_gpt_weights       – hot model switch
  GET  /set_sovits_weights
  GET  /health, /metrics      – liveness + engine metrics (JSON, Prometheus)
  POST /drain                 – graceful drain
  POST /v1/audio/speech       – OpenAI Audio API (``openai_compat.py``)
  GET  /v1/models, /v1/audio/voices

Each route is an ``async`` method of :class:`TTSServer` (the JAX handler's
name) that takes a plain dict — the parsed JSON body, or the query with
repeated keys as lists — and returns a :class:`Reply`: status, headers and a
body of ``bytes`` or a :class:`Stream` of ``bytes`` (SSE events, a streamed
wav/raw body).  A client's mistake raises :class:`HTTPError` with JAX's
status and text.  None of that imports ``aiohttp``, which the card's host
lacks; :func:`create_app` builds the aiohttp app from the methods and imports
it inside, raising when it is missing.
"""
from __future__ import annotations

import asyncio
import base64
import dataclasses
import functools
import hashlib
import io
import json
import logging
import mimetypes
import os
import re
import tempfile
import time
import uuid
import wave
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Union

import numpy as np

from ..utils.timing import Timings

# api_v2 cut-method → cut_minlen mapping (``personal_api.py:203-210``)
CUT_METHOD2MINLEN = {"cut0": 999, "cut1": 50, "cut2": 50, "cut3": 20,
                     "cut4": 20, "cut5": 10}

AUDIO_DIR = Path(tempfile.gettempdir()) / "gsv_tts_tpu_torch_audio"

_FALSY = (False, 0, "0", None, "", "false", "False")

SSE_HEADERS = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache",
               "Connection": "keep-alive", "X-Accel-Buffering": "no"}


def truthy(v) -> bool:
    """JSON bool fields arrive as strings from some clients — treat
    "false"/"0" as off (same tuple api_v2's GET parsing uses) instead of
    ``bool("false") is True`` silently enabling the option."""
    return v not in _FALSY


def is_url(path: str) -> bool:
    return isinstance(path, str) and path.startswith(("http://", "https://"))


# -- replies -------------------------------------------------------------------

class Stream:
    """A streamed reply body: the ``bytes`` an async generator yields, and an
    optional ``release`` callable run once when the body ends or is closed,
    whether or not it was ever iterated (an admission slot must come back even
    when the response never starts)."""

    def __init__(self, agen, release: Optional[Callable[[], None]] = None):
        self._agen = agen
        self._release = release

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        try:
            return await self._agen.__anext__()
        except BaseException:
            await self.aclose()
            raise

    async def aclose(self):
        try:
            await self._agen.aclose()
        finally:
            release, self._release = self._release, None
            if release is not None:
                release()


@dataclasses.dataclass
class Reply:
    """What a route answers: ``body`` is ``bytes``, or a :class:`Stream`
    written chunk by chunk after the status and headers."""
    status: int = 200
    headers: Dict[str, str] = dataclasses.field(default_factory=dict)
    body: Union[bytes, Stream] = b""


def json_reply(data, status: int = 200, headers: Optional[dict] = None) -> Reply:
    return Reply(status, {"Content-Type": "application/json; charset=utf-8", **(headers or {})},
                 json.dumps(data).encode())


def text_reply(text: str, status: int = 200, content_type: str = "text/plain") -> Reply:
    return Reply(status, {"Content-Type": f"{content_type}; charset=utf-8"}, text.encode())


def file_reply(path: Path) -> Reply:
    """A file's bytes, typed by its name as aiohttp's ``FileResponse`` types it."""
    ctype = mimetypes.guess_type(str(path))[0] or "application/octet-stream"
    return Reply(200, {"Content-Type": ctype}, path.read_bytes())


class HTTPError(Exception):
    """A reply other than 200 that a route raises (JAX raises aiohttp's
    ``HTTPBadRequest``, ``HTTPUnsupportedMediaType``, ``HTTPNotFound``)."""

    def __init__(self, status: int, text: str, content_type: str = "text/plain",
                 headers: Optional[dict] = None):
        super().__init__(f"{status}: {text}")
        self.status, self.text = status, text
        self.content_type, self.headers = content_type, dict(headers or {})

    def reply(self) -> Reply:
        r = text_reply(self.text, self.status, self.content_type)
        r.headers.update(self.headers)
        return r


def _bad_request(msg: str):
    raise HTTPError(400, json.dumps({"error": msg}), "application/json")


def parse_json(raw: bytes) -> dict:
    """Body parse that turns client mistakes into a clean 400 (the
    reference FastAPI surface answers 422) instead of a 500."""
    try:
        req = json.loads(raw.decode("utf-8"))
    except Exception:
        _bad_request("request body must be valid JSON")
    if not isinstance(req, dict):
        _bad_request("request body must be a JSON object")
    return req


def require(req: dict, *keys: str) -> None:
    missing = [k for k in keys if req.get(k) in (None, "", [])]
    if missing:
        _bad_request("missing required field(s): " + ", ".join(missing))


# -- audio packing -------------------------------------------------------------

def pack_raw(data: np.ndarray) -> bytes:
    return (np.clip(np.asarray(data, np.float32), -1, 1) * 32767).astype("<i2").tobytes()


def wave_header_chunk(frame_input: bytes = b"", channels: int = 1,
                      sample_width: int = 2, sample_rate: int = 32000) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sample_width)
        w.setframerate(sample_rate)
        w.writeframes(frame_input)
    buf.seek(0)
    return buf.read()


def pack_wav(data: np.ndarray, rate: int) -> bytes:
    return wave_header_chunk(pack_raw(data), sample_rate=rate)


#: soundfile-gated encodings (mp3/opus are NOT encodable: libsndfile
#: builds lack lame/opus and no pure-Python encoder is practical)
SF_FORMATS = {"ogg": "OGG", "aac": "AAC", "flac": "FLAC"}


@functools.lru_cache(maxsize=1)
def _supported_media_types() -> tuple:
    """wav/raw always; ogg/aac/flac only if the optional soundfile backend
    can actually encode them (probed once — importability alone is not
    enough: libsndfile builds differ in codec support).  api_v2 itself
    accepts only the reference's wav/raw/ogg/aac set; flac is probed for
    the OpenAI-compat surface."""
    out = ["wav", "raw"]
    try:
        import soundfile as sf

        for name, fmt in SF_FORMATS.items():
            try:
                buf = io.BytesIO()
                sf.write(buf, np.zeros(64, np.float32), 32000, format=fmt)
                out.append(name)
            except Exception:
                pass
    except ImportError:
        pass
    return tuple(out)


def _needs_soundfile(media_type: str) -> HTTPError:
    return HTTPError(415, json.dumps({
        "error": f"media_type '{media_type}' needs the optional `soundfile` encoder backend",
        "supported": _supported_media_types()}), "application/json")


def pack_audio(data: np.ndarray, rate: int, media_type: str) -> bytes:
    """api_v2 response packing.  wav/raw are always available; ogg/aac
    require the optional ``soundfile`` encoder — without it the request
    gets a documented 415 listing what IS supported."""
    if media_type == "raw":
        return pack_raw(data)
    if media_type == "wav":
        return pack_wav(data, rate)
    if media_type in SF_FORMATS:
        try:
            import soundfile as sf
        except ImportError:
            raise _needs_soundfile(media_type)
        try:
            buf = io.BytesIO()
            sf.write(buf, np.asarray(data, np.float32), rate, format=SF_FORMATS[media_type])
            return buf.getvalue()
        except Exception as e:  # encoder present but can't do this codec
            raise HTTPError(415, json.dumps({
                "error": f"encoder backend cannot produce '{media_type}': {e}",
                "supported": _supported_media_types()}), "application/json")
    raise HTTPError(400, json.dumps({"error": f"unknown media_type '{media_type}'",
                                     "supported": _supported_media_types()}),
                    "application/json")


def sse_event(event: str, data) -> bytes:
    return f"event: {event}\ndata: {json.dumps(data, ensure_ascii=False)}\n\n".encode()


def _clip_event(clip, **extra) -> dict:
    return {**extra,
            "audio": base64.b64encode(np.asarray(clip.audio_data, np.float32).tobytes()).decode(),
            "sample_rate": clip.samplerate, "duration": clip.audio_len_s,
            "subtitles": clip.subtitles, "text": clip.orig_text}


# -- what /health reports about the card ------------------------------------------

def compile_count(tts) -> int:
    """What compiles in the port, summed over the process: the facade's CUDA
    graph captures (the SoVITS programs and the vocoder batcher's, both in
    ``tts.sovits_graphs``) and the kernel libraries built or loaded.  A server
    reports it from its own start (``backend_compiles``): it must plateau
    under repeated traffic, or a shape is leaking into the graph keys."""
    from ..utils import cuda_build

    return tts.sovits_graphs.captures + len(cuda_build.build_info)


def device_name(tts) -> str:
    """The facade's torch device and, on a card, the card's name."""
    import torch

    dev = torch.device(tts.device)
    if dev.type != "cuda":
        return str(dev)
    return f"{dev} ({torch.cuda.get_device_name(dev)})"


def live_bytes(tts) -> int:
    """``torch.cuda.memory_allocated`` of the facade's card (0 on the CPU): the
    leak signal ``tools/soak.py`` watches as ``live_arrays``."""
    import torch

    dev = torch.device(tts.device)
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


class TTSServer:
    def __init__(self, tts, asr_fn=None, batch_window_ms: float = 0.0,
                 batch_max: int = 4, stream_share: bool = False):
        """``tts``: a ``gsv_tts_tpu_torch.TTS`` facade.  ``asr_fn``: optional
        callable (audio_path → transcript) used when prompt_text is omitted.
        ``batch_window_ms`` > 0 coalesces concurrent non-streaming api_v2
        requests arriving within the window into one continuous-batched
        synthesis call (``serving/batcher.py``); when >=2 requests coalesce,
        each is synthesized with the api's ``batch_infer=true`` semantics,
        and a flush wave holding ONE request keeps the single ``infer``.
        ``stream_share`` makes ``/tts/stream`` route through the shared wave
        scheduler by default (``TTS.stream_shared``); each request can
        override with ``"shared": true/false``."""
        self.tts = tts
        self.asr_fn = asr_fn
        self.stream_share = stream_share
        self.timings = Timings()
        #: graceful drain (POST /drain): new synthesis requests answer 503
        #: + Retry-After while in-flight streams finish
        self.draining = False
        self._inflight = 0
        self._compile_base = compile_count(tts)
        self.batcher = None
        if batch_window_ms > 0:
            from .batcher import MicroBatcher

            async def _single(spk, prompt, prompt_text, text, **params):
                # drop the batched-only cut kwargs: the lone-request path
                # mirrors the non-batched handler (tts_v2), which passes
                # only the sampling kwargs to infer_async
                kw = {k: v for k, v in params.items()
                      if k not in ("is_cut_text", "cut_minlen", "cut_mute")}
                return await tts.infer_async(
                    spk_audio_path=spk, prompt_audio_path=prompt,
                    prompt_audio_text=prompt_text, text=text, **kw)

            self.batcher = MicroBatcher(tts, max_batch=batch_max,
                                        max_wait_ms=batch_window_ms,
                                        single_call=_single)
        AUDIO_DIR.mkdir(exist_ok=True)

    # -- helpers -----------------------------------------------------------

    async def _download_audio(self, url: str) -> str:
        import aiohttp

        suffix = os.path.splitext(url.split("?")[0])[1] or ".wav"
        # URL-keyed cache: repeated requests for the same reference clip
        # reuse the file instead of growing AUDIO_DIR unboundedly
        key = hashlib.sha1(url.encode()).hexdigest()[:24]
        out = AUDIO_DIR / f"dl_{key}{suffix}"
        if out.exists():
            out.touch()  # keep hot entries past the TTL sweep
            return str(out)
        self._sweep_audio_dir()
        async with aiohttp.ClientSession() as session:
            async with session.get(url) as resp:
                resp.raise_for_status()
                tmp = out.with_suffix(out.suffix + f".{uuid.uuid4().hex}.part")
                tmp.write_bytes(await resp.read())
                tmp.replace(out)  # atomic: concurrent same-URL requests race safely
        return str(out)

    @staticmethod
    def _sweep_audio_dir(ttl_s: float = 3600.0):
        """Drop downloads/batch results older than ``ttl_s``."""
        cutoff = time.time() - ttl_s
        try:
            for f in AUDIO_DIR.iterdir():
                try:
                    if f.stat().st_mtime < cutoff:
                        f.unlink()
                except OSError:
                    pass
        except OSError:
            pass

    async def _resolve_audio(self, path: str) -> str:
        if is_url(path):
            return await self._download_audio(path)
        return path

    async def _resolve_prompt(self, prompt_audio: str, prompt_text: Optional[str]) -> str:
        if prompt_text:
            return prompt_text
        if self.asr_fn is not None:
            # the ASR backend blocks: off the event loop
            text = await asyncio.get_running_loop().run_in_executor(
                None, self.asr_fn, prompt_audio)
            if text:
                return text
        raise HTTPError(400, "prompt_text is required (no ASR backend configured)")

    def _stats(self) -> dict:
        return {**self.timings.summary(), **self.tts.get_timings()}

    # -- endpoints ---------------------------------------------------------

    async def root(self, req=None) -> Reply:
        return json_reply({
            "service": "gsv-tts-lite-tpu",
            "endpoints": ["/tts/stream", "/tts/stream/batched", "/tts/batched",
                          "/tts", "/set_gpt_weights", "/set_sovits_weights",
                          "/audio/{filename}", "/health",
                          "/v1/audio/speech", "/v1/models",
                          "/v1/audio/voices"],
        })

    async def health(self, req=None) -> Reply:
        payload = {
            "status": "ok",
            "draining": self.draining,
            "inflight": self._inflight,
            "warmed": self.tts._warmed,
            "device": device_name(self.tts),
            "gpt_models": [str(p) for p in self.tts.get_gpt_list()],
            "sovits_models": [str(p) for p in self.tts.get_sovits_list()],
            "timings": self._stats(),
            # leak observability (tools/soak.py): compiles must plateau,
            # the card's allocated bytes must stay bounded across churn
            "backend_compiles": compile_count(self.tts) - self._compile_base,
            "live_arrays": live_bytes(self.tts),
        }
        if self.batcher is not None:
            payload["batcher"] = self.batcher.stats
        waves = self.tts.wave_stats()
        if waves:
            payload["waves"] = waves
        vb = self.tts.vocoder_batch_stats()
        if vb:
            payload["vocoder_batcher"] = vb
        return json_reply(payload)

    async def drain(self, req: dict) -> Reply:
        """POST /drain: stop admitting synthesis requests (503 +
        Retry-After) while in-flight streams finish — the rolling-restart
        primitive for fleet replicas.  Body ``{"enable": false}`` re-opens."""
        self.draining = truthy(req.get("enable", True))
        return json_reply({"draining": self.draining, "inflight": self._inflight})

    async def metrics(self, req=None) -> Reply:
        """Prometheus text exposition of the serving counters — the same
        data /health reports as JSON, flattened into scrapeable gauges."""
        def clean(name: str) -> str:
            return re.sub(r"[^a-zA-Z0-9_]", "_", name)

        lines = ["# TYPE gsv_up gauge", "gsv_up 1",
                 f"gsv_backend_compiles {compile_count(self.tts) - self._compile_base}",
                 f"gsv_live_arrays {live_bytes(self.tts)}"]
        for name, st in sorted(self._stats().items()):
            base = "gsv_" + clean(name)
            if isinstance(st, dict):
                for k, v in st.items():
                    if isinstance(v, (int, float)):
                        lines.append(f"{base}_{clean(k)} {v:g}")
            elif isinstance(st, (int, float)):
                lines.append(f"{base} {st:g}")
        if self.batcher is not None:
            for k, v in self.batcher.stats.items():
                if isinstance(v, (int, float)):
                    lines.append(f"gsv_batcher_{clean(k)} {v:g}")
        for model, ws in (self.tts.wave_stats() or {}).items():
            if not isinstance(ws, dict):
                continue
            ml = f'model="{clean(os.path.basename(str(model)))}"'
            for k in ("clients", "max_clients", "max_batch"):
                v = ws.get(k)
                if isinstance(v, (int, float)):
                    lines.append(f"gsv_wave_{k}{{{ml}}} {v:g}")
            for i, w in enumerate(ws.get("waves", [])):
                wl = f'{ml},wave="{i}"'
                for k in ("batch", "live", "pending", "attached", "finished", "refills",
                          "batched_refills", "resizes"):
                    v = w.get(k)
                    if isinstance(v, (int, float)):
                        lines.append(f"gsv_wave_{k}{{{wl}}} {v:g}")
        for k, v in (self.tts.vocoder_batch_stats() or {}).items():
            if isinstance(v, (int, float)):
                lines.append(f"gsv_vocoder_batcher_{clean(k)} {v:g}")
        return text_reply("\n".join(lines) + "\n")

    async def tts_stream(self, req: dict) -> Reply:
        """SSE streaming: audio / done / error events.  Shared clients claim
        their admission slot here, before the reply starts, so a client past
        the cap gets a clean 503 + Retry-After and never an SSE byte."""
        require(req, "text", "speaker_audio", "prompt_audio")
        try:
            kw = dict(
                return_subtitles=truthy(req.get("return_subtitles", False)),
                is_cut_text=truthy(req.get("is_cut_text", True)),
                cut_minlen=int(req.get("cut_minlen", 10)),
                cut_mute=float(req.get("cut_mute", 0.3)),
                stream_chunk=int(req.get("stream_chunk", 25)),
                overlap_len=int(req.get("overlap_len", 5)),
                top_k=int(req.get("top_k", 15)),
                top_p=float(req.get("top_p", 1.0)),
                temperature=float(req.get("temperature", 1.0)),
                repetition_penalty=float(req.get("repetition_penalty", 1.35)),
                noise_scale=float(req.get("noise_scale", 0.5)),
                speed=float(req.get("speed", 1.0)),
                debug=False,
            )
        except (TypeError, ValueError) as e:
            # a client's malformed numeric is a 400, not a mid-SSE error
            _bad_request(f"invalid parameter value: {e}")
        shared = truthy(req.get("shared", self.stream_share))
        release = None
        if shared:
            from ..runtime.wave import WaveOverloadedError

            try:
                release = self.tts.admit_shared_client()
            except WaveOverloadedError:
                return json_reply({"error": "server at capacity (max concurrent shared "
                                            "streams reached)"},
                                  503, {"Retry-After": "1"})
        try:
            speaker_audio = await self._resolve_audio(req["speaker_audio"])
            prompt_audio = await self._resolve_audio(req["prompt_audio"])
            prompt_text = await self._resolve_prompt(prompt_audio, req.get("prompt_text"))
        except BaseException:
            if release is not None:
                release()
            raise
        args = dict(spk_audio_path=speaker_audio, prompt_audio_path=prompt_audio,
                    prompt_audio_text=prompt_text, text=req["text"])
        if shared:
            # sentence mode maps to a huge chunk as in infer_stream;
            # boost_first_chunk has no batched analogue
            if req.get("stream_mode", "token") == "sentence":
                kw["stream_chunk"] = 10000
            start = functools.partial(self.tts.stream_shared_async, **args,
                                      admitted=release is not None, **kw)
        else:
            start = functools.partial(
                self.tts.infer_stream_async, **args,
                stream_mode=req.get("stream_mode", "token"),
                boost_first_chunk=truthy(req.get("boost_first_chunk", True)), **kw)
        return Reply(200, dict(SSE_HEADERS), Stream(self._sse_clips(start), release))

    async def _sse_clips(self, start):
        """``event: audio`` per clip of ``start()``'s stream, then one
        ``event: done``; a failure mid-stream becomes ``event: error``."""
        t0 = time.perf_counter()
        first, total_len, agen = True, 0, None
        try:
            agen = start()
            async for clip in agen:
                if first:
                    self.timings.record("ttfa_s", time.perf_counter() - t0)
                    first = False
                total_len += len(clip.audio_data)
                yield sse_event("audio", _clip_event(clip))
            yield sse_event("done", {"total_duration": total_len / self.tts.samplerate})
        except Exception as e:  # noqa: BLE001 — the client sees it as an event
            logging.exception("stream inference error")
            yield sse_event("error", {"error": str(e)})
        finally:
            if agen is not None:  # a client that went away detaches the worker
                await agen.aclose()

    async def tts_stream_batched(self, req: dict) -> Reply:
        """SSE streaming continuous batching: N texts synthesize
        concurrently through the batched engine; each ``audio`` event is
        tagged with its request ``index`` and a per-request ``done`` flag."""
        require(req, "texts", "speaker_audio", "prompt_audio")
        speaker_audio = await self._resolve_audio(req["speaker_audio"])
        prompt_audio = await self._resolve_audio(req["prompt_audio"])
        prompt_text = await self._resolve_prompt(prompt_audio, req.get("prompt_text"))
        return Reply(200, dict(SSE_HEADERS), Stream(self._sse_batched(
            req, speaker_audio, prompt_audio, prompt_text)))

    async def _sse_batched(self, req, speaker_audio, prompt_audio, prompt_text):
        t0 = time.perf_counter()
        first, agen = True, None
        try:
            # the parameters are read after the reply started, as JAX reads
            # them: a malformed one is an error event
            agen = self.tts.infer_batched_stream_async(
                spk_audio_paths=speaker_audio,
                prompt_audio_paths=prompt_audio,
                prompt_audio_texts=prompt_text,
                texts=req["texts"],
                return_subtitles=truthy(req.get("return_subtitles", False)),
                is_cut_text=truthy(req.get("is_cut_text", True)),
                cut_minlen=int(req.get("cut_minlen", 10)),
                cut_mute=float(req.get("cut_mute", 0.3)),
                stream_chunk=int(req.get("stream_chunk", 25)),
                overlap_len=int(req.get("overlap_len", 5)),
                top_k=int(req.get("top_k", 15)),
                top_p=float(req.get("top_p", 1.0)),
                temperature=float(req.get("temperature", 1.0)),
                repetition_penalty=float(req.get("repetition_penalty", 1.35)),
                noise_scale=float(req.get("noise_scale", 0.5)),
                speed=float(req.get("speed", 1.0)),
            )
            async for idx, clip, req_done in agen:
                if first:
                    self.timings.record("ttfa_s", time.perf_counter() - t0)
                    first = False
                yield sse_event("audio", _clip_event(clip, index=int(idx), done=bool(req_done)))
            yield b"event: done\ndata: {}\n\n"
        except Exception as e:  # noqa: BLE001 — the client sees it as an event
            logging.exception("batched stream inference error")
            yield sse_event("error", {"error": str(e)})
        finally:
            if agen is not None:
                await agen.aclose()

    async def tts_batched(self, req: dict) -> Reply:
        require(req, "texts", "speaker_audio", "prompt_audio")
        speaker_audio = await self._resolve_audio(req["speaker_audio"])
        prompt_audio = await self._resolve_audio(req["prompt_audio"])
        prompt_text = await self._resolve_prompt(prompt_audio, req.get("prompt_text"))

        t0 = time.perf_counter()
        clips = await self.tts.infer_batched_async(
            spk_audio_paths=speaker_audio,
            prompt_audio_paths=prompt_audio,
            prompt_audio_texts=prompt_text,
            texts=req["texts"],
            return_subtitles=truthy(req.get("return_subtitles", False)),
            is_cut_text=truthy(req.get("is_cut_text", True)),
            cut_minlen=int(req.get("cut_minlen", 10)),
            cut_mute=float(req.get("cut_mute", 0.3)),
            top_k=int(req.get("top_k", 15)),
            top_p=float(req.get("top_p", 1.0)),
            temperature=float(req.get("temperature", 1.0)),
            repetition_penalty=float(req.get("repetition_penalty", 1.35)),
            noise_scale=float(req.get("noise_scale", 0.5)),
            speed=float(req.get("speed", 1.0)),
        )
        self.timings.record("batched_s", time.perf_counter() - t0)

        from ..utils.audio_io import save_wav

        results = []
        self._sweep_audio_dir()
        for i, clip in enumerate(clips):
            fname = f"batch_{uuid.uuid4().hex}_{i}.wav"
            save_wav(str(AUDIO_DIR / fname), np.asarray(clip.audio_data), clip.samplerate)
            results.append({
                "text": clip.orig_text,
                "duration": clip.audio_len_s,
                "audio_url": f"/audio/{fname}",
                "subtitles": clip.subtitles,
            })
        return json_reply({"results": results})

    async def get_audio(self, req: dict) -> Reply:
        filename = req["filename"]
        path = AUDIO_DIR / os.path.basename(filename)
        if not path.exists():
            raise HTTPError(404, f"audio {filename} not found")
        return file_reply(path)

    # -- api_v2 compatibility ---------------------------------------------

    async def tts_v2(self, req: Dict[str, Any]) -> Reply:
        ref_audio_path = req.get("ref_audio_path")
        if not ref_audio_path:
            raise HTTPError(400, "ref_audio_path is required")
        ref_audio_path = await self._resolve_audio(ref_audio_path)
        aux = req.get("aux_ref_audio_paths") or []
        if isinstance(aux, str):  # a query key given once arrives unlisted
            aux = [aux]
        if aux:
            speaker_audio: Any = {p: 1.0 for p in [ref_audio_path] + aux}
        else:
            speaker_audio = ref_audio_path
        prompt_text = await self._resolve_prompt(ref_audio_path, req.get("prompt_text"))

        text_input = req.get("text")
        if text_input in (None, ""):
            raise HTTPError(400, "text is required")
        media_type = req.get("media_type", "wav")
        if media_type not in {"wav", "raw", "ogg", "aac"}:
            raise HTTPError(400, json.dumps({"error": f"unknown media_type '{media_type}'",
                                             "supported": _supported_media_types()}),
                            "application/json")
        if media_type not in _supported_media_types():
            # reject before synthesizing: ogg/aac need the optional encoder
            raise _needs_soundfile(media_type)

        streaming_mode = req.get("streaming_mode", False)
        stream_enabled = streaming_mode not in _FALSY
        batch_infer = req.get("batch_infer", False) not in _FALSY
        if batch_infer and stream_enabled:
            raise HTTPError(400, "batch_infer is not supported with streaming_mode")

        cut_method = req.get("text_split_method", "cut1")
        cut = dict(is_cut_text=cut_method not in {"", "cut0", "none"},
                   cut_minlen=CUT_METHOD2MINLEN.get(cut_method, 10))
        kw = dict(
            top_k=int(req.get("top_k", 15)),
            top_p=float(req.get("top_p", 1.0)),
            temperature=float(req.get("temperature", 1.0)),
            repetition_penalty=float(req.get("repetition_penalty", 1.35)),
            noise_scale=float(req.get("noise_scale", 0.5)),
            speed=float(req.get("speed_factor", 1.0)),
        )
        audio_type = {"Content-Type": f"audio/{media_type}"}

        if batch_infer:
            clips = await self.tts.infer_batched_async(
                spk_audio_paths=speaker_audio, prompt_audio_paths=ref_audio_path,
                prompt_audio_texts=prompt_text, texts=text_input,
                cut_mute=float(req.get("fragment_interval", 0.3)), **cut, **kw)
            merged = np.concatenate([np.asarray(c.audio_data) for c in clips])
            return Reply(200, audio_type, pack_audio(merged, clips[0].samplerate, media_type))

        if stream_enabled:
            try:  # "true"/"True"/True all mean mode 1 (api_v2 GET strings)
                mode_value = int(streaming_mode)
            except (TypeError, ValueError):
                mode_value = 1
            agen = self.tts.infer_stream_async(
                spk_audio_path=speaker_audio, prompt_audio_path=ref_audio_path,
                prompt_audio_text=prompt_text, text=text_input,
                cut_mute=float(req.get("fragment_interval", 0.3)), stream_mode="token",
                stream_chunk=max(1, int(req.get("min_chunk_length", 25))),
                overlap_len=max(1, int(req.get("overlap_length", 5))),
                boost_first_chunk=(mode_value == 1), debug=False, **cut, **kw)
            return Reply(200, audio_type, Stream(self._audio_chunks(agen, media_type)))

        if self.batcher is not None:
            # coalesce with other in-window requests into one batched call
            clip = await self.batcher.infer(
                speaker_audio, ref_audio_path, prompt_text, text_input,
                cut_mute=float(req.get("fragment_interval", 0.3)), **cut, **kw)
        else:
            clip = await self.tts.infer_async(
                spk_audio_path=speaker_audio, prompt_audio_path=ref_audio_path,
                prompt_audio_text=prompt_text, text=text_input, **kw)
        return Reply(200, audio_type, pack_audio(clip.audio_data, clip.samplerate, media_type))

    @staticmethod
    async def _audio_chunks(agen, media_type: str):
        """api_v2's streamed body: for wav, a header chunk and then raw frames."""
        first = True
        try:
            async for clip in agen:
                if first and media_type == "wav":
                    yield wave_header_chunk(sample_rate=clip.samplerate)
                    first = False
                    yield pack_audio(clip.audio_data, clip.samplerate, "raw")
                else:
                    yield pack_audio(clip.audio_data, clip.samplerate,
                                     "raw" if media_type == "wav" else media_type)
        finally:
            await agen.aclose()

    async def _switch_weights(self, req: dict, kind: str) -> Reply:
        path = req.get("weights_path")
        if not path:
            raise HTTPError(400, "weights_path is required")
        tts = self.tts
        listed, load, unload = {
            "GPT": (tts.get_gpt_list, tts.load_gpt_model, tts.unload_gpt_model),
            "SoVITS": (tts.get_sovits_list, tts.load_sovits_model, tts.unload_sovits_model),
        }[kind]

        def switch():
            # serialize against in-flight inference; load FIRST, unload the
            # others only on success (a corrupt checkpoint leaves the old
            # model serving; the router fans this out fleet-wide)
            with tts._infer_lock:
                old = [m for m in listed() if str(m) != str(path)]
                load(path)
                for model in old:
                    unload(model)

        # a checkpoint load takes seconds: never on the event loop
        try:
            await asyncio.get_running_loop().run_in_executor(None, switch)
        except Exception as exc:  # noqa: BLE001 — bad/corrupt/malicious checkpoint
            logging.warning("set_%s_weights(%s) failed: %s", kind.lower(), path, exc)
            return json_reply({"message": f"failed to load {kind} weights: {exc}"}, 400)
        return json_reply({"message": "success"})

    async def set_gpt_weights(self, req: dict) -> Reply:
        return await self._switch_weights(req, "GPT")

    async def set_sovits_weights(self, req: dict) -> Reply:
        return await self._switch_weights(req, "SoVITS")


#: routes gated by graceful drain (POST /drain) and counted as in-flight
SYNTH_PATHS = ("/tts", "/tts/stream", "/tts/stream/batched", "/tts/batched",
               "/v1/audio/speech")


# -- the aiohttp adapter -----------------------------------------------------------

def require_aiohttp():
    """aiohttp's ``web`` module; an ``ImportError`` without it (never a fallback)."""
    try:
        from aiohttp import web
    except ImportError as e:
        raise ImportError("The serving layer requires `aiohttp`") from e
    return web


async def query_dict(request) -> dict:
    """The query as JAX's GET handlers read it: the first value of every key
    (``dict`` of aiohttp's multidict), and ``aux_ref_audio_paths``, which
    api_v2 lets repeat (a multi-speaker blend), as the list of its values
    when it is given more than once."""
    q = request.query
    req = dict(q)
    aux = q.getall("aux_ref_audio_paths", [])
    if len(aux) > 1:
        req["aux_ref_audio_paths"] = list(aux)
    return req


async def json_body(request) -> dict:
    return parse_json(await request.read())


async def path_params(request) -> dict:
    return dict(request.match_info)


async def no_body(request):
    return None


async def lenient_body(request) -> dict:
    """/drain's body: empty or invalid reads as ``{}`` (enable)."""
    req = {}
    if request.can_read_body:
        try:
            req = await request.json()
        except Exception:  # noqa: BLE001 — empty/invalid body = enable
            req = {}
    return req if isinstance(req, dict) else {}


async def send(request, reply: Reply):
    """Write ``reply`` on aiohttp: a ``bytes`` body as one response; a
    :class:`Stream` after ``prepare`` (so its first byte follows the status),
    chunk by chunk, ended by ``write_eof``.  A client that goes away stops the
    writes: the stream is closed (its worker detached) and nothing more is
    written to the socket."""
    import aiohttp
    from aiohttp import web

    if not isinstance(reply.body, Stream):
        return web.Response(status=reply.status, body=reply.body, headers=reply.headers)
    resp = web.StreamResponse(status=reply.status, headers=reply.headers)
    try:
        await resp.prepare(request)
        async for chunk in reply.body:
            try:
                await resp.write(chunk)
            except (ConnectionResetError, ConnectionError,
                    aiohttp.ClientConnectionError) as e:
                # a routine client disconnect, not an inference error
                logging.info("client disconnected mid-stream: %s", e)
                return resp
        await resp.write_eof()
        return resp
    finally:
        await reply.body.aclose()


def handler(method, parse=json_body):
    """An aiohttp handler of a route method: ``parse(request)`` gives its
    argument, an :class:`HTTPError` its reply."""
    async def handle(request):
        try:
            reply = await method(await parse(request))
        except HTTPError as e:
            reply = e.reply()
        return await send(request, reply)

    return handle


def _drain_middleware(server, web):
    """The drain gate of :data:`SYNTH_PATHS` (503 + Retry-After while
    draining), counting their in-flight requests, streams included."""
    @web.middleware
    async def middleware(request, handler):
        if request.path in SYNTH_PATHS:
            if server.draining:
                return await send(request, json_reply({"error": "server draining"}, 503,
                                                      {"Retry-After": "5"}))
            server._inflight += 1
            try:
                return await handler(request)
            finally:
                server._inflight -= 1
        return await handler(request)

    return middleware


def create_app(tts, asr_fn=None, batch_window_ms: float = 0.0,
               batch_max: int = 4, stream_share: bool = False,
               voices: Optional[Dict[str, dict]] = None):
    """The aiohttp app of :class:`TTSServer`'s routes and the OpenAI ones."""
    web = require_aiohttp()
    server = TTSServer(tts, asr_fn=asr_fn, batch_window_ms=batch_window_ms,
                       batch_max=batch_max, stream_share=stream_share)
    app = web.Application(middlewares=[_drain_middleware(server, web)])
    app["server"] = server
    if server.batcher is not None:
        async def _close_batcher(app):
            await server.batcher.close()
        app.on_cleanup.append(_close_batcher)
    app.router.add_get("/", handler(server.root, no_body))
    app.router.add_get("/health", handler(server.health, no_body))
    app.router.add_get("/metrics", handler(server.metrics, no_body))
    app.router.add_post("/drain", handler(server.drain, lenient_body))
    app.router.add_post("/tts/stream", handler(server.tts_stream))
    app.router.add_post("/tts/stream/batched", handler(server.tts_stream_batched))
    app.router.add_post("/tts/batched", handler(server.tts_batched))
    app.router.add_get("/audio/{filename}", handler(server.get_audio, path_params))
    app.router.add_get("/tts", handler(server.tts_v2, query_dict))
    app.router.add_post("/tts", handler(server.tts_v2))
    app.router.add_get("/set_gpt_weights", handler(server.set_gpt_weights, query_dict))
    app.router.add_get("/set_sovits_weights", handler(server.set_sovits_weights, query_dict))
    from .openai_compat import add_openai_routes

    add_openai_routes(app, server, voices)
    return app


DEVICE_HELP = ("N pins the engine to cuda:N (one server process per card, fronted "
               "by serving.router or serving.fleet); 'cpu' runs it on the CPU; "
               "without it the engine takes the card and fails when there is none")


def engine_device(arg: Optional[str]):
    """The facade's device for a ``--device`` flag: None (the card; the facade
    raises without one), ``"cpu"``, or a card index ``N``, which also makes
    cuda:N this process's current card."""
    if arg is None or arg == "cpu":
        return arg
    import torch

    torch.cuda.set_device(int(arg))
    return f"cuda:{int(arg)}"


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="gsv-tts-lite HTTP server on the PyTorch port")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9880)
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--gpt", default=None, help="GPT checkpoint path")
    ap.add_argument("--sovits", default=None, help="SoVITS checkpoint path")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="coalesce concurrent non-streaming api_v2 requests "
                         "arriving within this window into one batched "
                         "synthesis call (0 = off; coalesced requests get "
                         "batch_infer=true semantics: text split + "
                         "fragment_interval pauses)")
    ap.add_argument("--batch-max", type=int, default=4,
                    help="max requests per coalesced batch")
    ap.add_argument("--quant-t2s", nargs="?", const="int8", default=False,
                    choices=("int8", "int4"),
                    help="quantized weight-streaming GPT decode: bare flag or "
                         "'int8' = fused_step_q8, 'int4' = fused_step_q4; "
                         "sampled tokens shift by the rounding error vs bf16")
    ap.add_argument("--quant-bert", action="store_true",
                    help="int8 BERT featurizer linear layers")
    ap.add_argument("--featurizer-buckets", action="store_true",
                    help="pad the BERT/HuBERT featurizer inputs to a ladder "
                         "of shapes")
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--stream-share", action="store_true",
                    help="route /tts/stream through the shared wave "
                         "scheduler by default (per-request override via "
                         "\"shared\": true/false)")
    ap.add_argument("--voices", default=None,
                    help="JSON voice registry for the OpenAI-compatible "
                         "surface: maps voice names to {speaker_audio, "
                         "prompt_audio, prompt_text} bundles")
    ap.add_argument("--warmup", action="store_true",
                    help="run one short synthesis (and one shared-wave "
                         "stream under --stream-share) BEFORE listening, so "
                         "the SoVITS graphs are captured when the first "
                         "request lands")
    ap.add_argument("--max-streams", type=int, default=None,
                    help="admission cap on concurrent shared streaming "
                         "clients: past it /tts/stream returns 503 + "
                         "Retry-After instead of queueing (default unbounded)")
    args = ap.parse_args(argv)

    web = require_aiohttp()
    from ..tts import TTS

    tts = TTS(models_dir=args.models_dir, device=engine_device(args.device), dtype=args.dtype,
              quant_t2s=args.quant_t2s, quant_bert=args.quant_bert,
              wave_max_clients=args.max_streams,
              featurizer_buckets=args.featurizer_buckets)
    if args.gpt:
        tts.load_gpt_model(args.gpt)
    if args.sovits:
        tts.load_sovits_model(args.sovits)
    from ..utils.native import native_lib

    native_lib()  # the host DSP library builds now, not on the first stream or subtitle request
    from .asr import make_asr_fn

    voices = None
    if args.voices:
        from .openai_compat import load_voices

        voices = load_voices(args.voices)
    if args.warmup:
        # /health stays unreachable (= unhealthy to the router / fleet)
        # until the first request can be served capture-free
        voice = next(iter(voices.values())) if voices else None
        tts.warmup(voice=voice, stream=args.stream_share)
    web.run_app(create_app(tts, asr_fn=make_asr_fn(),
                           batch_window_ms=args.batch_window_ms,
                           batch_max=args.batch_max,
                           stream_share=args.stream_share,
                           voices=voices),
                host=args.host, port=args.port)


if __name__ == "__main__":
    main()
