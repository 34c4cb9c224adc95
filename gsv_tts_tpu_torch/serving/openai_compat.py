"""OpenAI-compatible speech surface: ``POST /v1/audio/speech`` (counterpart of
``gsv_tts_tpu/serving/openai_compat.py``, with its schema, statuses and error
envelope).

Voice names map to reference-audio bundles via a JSON registry
(``--voices`` on the server CLI)::

    {"alloy": {"speaker_audio": "/path/spk.wav",
               "prompt_audio": "/path/prompt.wav",
               "prompt_text": "reference transcript."}}

Request fields: ``model`` (accepted, one engine serves), ``input`` (the text,
required), ``voice`` (a registry name; or ``speaker_audio`` /
``prompt_audio`` / ``prompt_text`` given directly), ``response_format``
(``wav`` | ``pcm`` always, ``flac`` / ``aac`` / ``ogg`` with the optional
soundfile encoder, never ``mp3`` / ``opus``; default ``wav``), ``speed``
(0.25-4.0), ``stream_format`` (``"audio"``, or ``"sse"``: ``data:
{"type": "speech.audio.delta", "audio": <b64 pcm16>}`` events, then one
``speech.audio.done``), and the sampling passthrough ``top_k`` / ``top_p`` /
``temperature`` / ``repetition_penalty`` / ``noise_scale`` /
``stream_chunk``.  Errors use the OpenAI envelope ``{"error": {"message",
"type", "param"}}``.  Also served: ``GET /v1/models`` and ``GET
/v1/audio/voices``.

The handlers are plain ``async`` methods of dicts to
:class:`server.Reply`, as the server's are; :func:`add_openai_routes` puts
them on an aiohttp app.
"""
from __future__ import annotations

import base64
import functools
import json
import logging
import time
from typing import Any, Dict, Optional

from .server import (SF_FORMATS, HTTPError, Reply, Stream, _supported_media_types,
                     handler, json_reply, no_body, pack_audio, pack_raw, pack_wav,
                     parse_json, truthy)

__all__ = ["add_openai_routes", "load_voices"]

_CONTENT_TYPES = {"wav": "audio/wav", "pcm": "audio/pcm",
                  "flac": "audio/flac", "aac": "audio/aac",
                  "ogg": "audio/ogg"}


def load_voices(path: str) -> Dict[str, dict]:
    """Load and validate a ``--voices`` JSON registry."""
    with open(path, "r", encoding="utf-8") as f:
        voices = json.load(f)
    if not isinstance(voices, dict):
        raise ValueError(f"{path}: voices registry must be a JSON object")
    for name, v in voices.items():
        if not isinstance(v, dict) or not v.get("speaker_audio") \
                or not v.get("prompt_audio"):
            raise ValueError(
                f"{path}: voice '{name}' needs speaker_audio and "
                f"prompt_audio (prompt_text optional when an ASR backend "
                f"is configured)")
    return voices


def _supported_formats() -> tuple:
    """OpenAI format names available here: wav/pcm always, plus whatever
    the server's shared soundfile probe can encode."""
    gated = tuple(f for f in _supported_media_types() if f in SF_FORMATS)
    return ("wav", "pcm") + gated


def _error(status: int, message: str, param: Optional[str] = None,
           err_type: str = "invalid_request_error",
           headers: Optional[dict] = None) -> Reply:
    return json_reply({"error": {"message": message, "type": err_type, "param": param}},
                      status, headers)


def _pack(data, rate: int, fmt: str) -> bytes:
    if fmt == "pcm":
        return pack_raw(data)
    if fmt == "wav":
        return pack_wav(data, rate)
    return pack_audio(data, rate, fmt)  # gated by _supported_formats()


async def speech_body(request) -> dict:
    """The speech route's body; a malformed one is a 400 in the OpenAI envelope."""
    try:
        return parse_json(await request.read())
    except HTTPError as e:
        raise HTTPError(400, json.dumps({"error": {
            "message": json.loads(e.text)["error"], "type": "invalid_request_error",
            "param": None}}), "application/json") from None


class _OpenAISpeech:
    """Handlers; ``server`` is the hosting :class:`TTSServer` (shares its
    audio-URL resolution, ASR prompt fallback, and timing reservoirs)."""

    def __init__(self, server, voices: Optional[Dict[str, dict]]):
        self.server = server
        self.voices = voices or {}
        self.started = int(time.time())  # /v1/models "created" epoch

    # -- request resolution --------------------------------------------

    async def _resolve_voice(self, req: dict):
        """Returns ``(speaker_audio, prompt_audio, prompt_text)`` or an
        error reply."""
        if req.get("speaker_audio") and req.get("prompt_audio"):
            spec: Dict[str, Any] = {k: req.get(k) for k in
                                    ("speaker_audio", "prompt_audio", "prompt_text")}
        else:
            voice = req.get("voice")
            if not voice:
                return _error(400, "missing 'voice' (and no speaker_audio/"
                                   "prompt_audio escape-hatch fields)", param="voice")
            spec = self.voices.get(str(voice))
            if spec is None:
                avail = sorted(self.voices)
                detail = (f"available: {avail}" if avail else
                          "no voices configured (start the server with "
                          "--voices registry.json)")
                return _error(400, f"unknown voice '{voice}'; {detail}", param="voice")
        spk = await self.server._resolve_audio(spec["speaker_audio"])
        prompt = await self.server._resolve_audio(spec["prompt_audio"])
        try:
            prompt_text = await self.server._resolve_prompt(prompt, spec.get("prompt_text"))
        except HTTPError as e:
            # "prompt_text required, no ASR backend" in the OpenAI envelope
            return _error(400, e.text, param="voice")
        return spk, prompt, prompt_text

    @staticmethod
    def _speed(req: dict):
        try:
            speed = float(req.get("speed", 1.0))
        except (TypeError, ValueError):
            return _error(400, "speed must be a number", param="speed")
        if not 0.25 <= speed <= 4.0:  # the OpenAI bounds
            return _error(400, "speed must be between 0.25 and 4.0", param="speed")
        return speed

    @staticmethod
    def _sampling_kw(req: dict):
        """Optional sampling passthrough: top_k/top_p/temperature/
        repetition_penalty/noise_scale map straight to the facade."""
        kw: Dict[str, Any] = {}
        for key, cast in (("top_k", int), ("top_p", float), ("temperature", float),
                          ("repetition_penalty", float), ("noise_scale", float)):
            if req.get(key) is not None:
                try:
                    kw[key] = cast(req[key])
                except (TypeError, ValueError):
                    return _error(400, f"{key} must be numeric", param=key)
        return kw

    # -- endpoints -------------------------------------------------------

    async def speech(self, req: dict) -> Reply:
        text = req.get("input")
        if not text or not isinstance(text, str):
            return _error(400, "'input' is required", param="input")
        fmt = str(req.get("response_format", "wav")).lower()
        supported = _supported_formats()
        if fmt not in supported:
            known = fmt in ("mp3", "opus") or fmt in SF_FORMATS
            return _error(415 if known else 400,
                          f"response_format '{fmt}' is not available on this server; "
                          f"supported: {list(supported)}", param="response_format")
        speed = self._speed(req)
        if isinstance(speed, Reply):
            return speed
        kw = self._sampling_kw(req)
        if isinstance(kw, Reply):
            return kw
        try:  # validate BEFORE any SSE byte — a bad value after the 200
            chunk = int(req.get("stream_chunk", 25))
        except (TypeError, ValueError):
            return _error(400, "stream_chunk must be an integer", param="stream_chunk")
        try:
            resolved = await self._resolve_voice(req)
            if isinstance(resolved, Reply):
                return resolved
            spk, prompt, prompt_text = resolved

            if str(req.get("stream_format", "audio")) == "sse":
                return self._speech_sse(req, text, fmt, speed, kw, chunk, spk, prompt,
                                        prompt_text)

            t0 = time.perf_counter()
            clip = await self.server.tts.infer_async(
                spk_audio_path=spk, prompt_audio_path=prompt,
                prompt_audio_text=prompt_text, text=text, speed=speed, **kw)
            # whole-utterance time — NOT the ttfa_s reservoir
            self.server.timings.record("synth_s", time.perf_counter() - t0)
            return Reply(200, {"Content-Type": _CONTENT_TYPES[fmt]},
                         _pack(clip.audio_data, clip.samplerate, fmt))
        except HTTPError as e:
            # keep the status, re-shape the body into the OpenAI envelope
            return _error(e.status, e.text, err_type="invalid_request_error"
                          if e.status < 500 else "server_error")
        except Exception as e:  # noqa: BLE001 — envelope, not a raw 500 page
            logging.exception("openai speech failure")
            return _error(500, str(e), err_type="server_error")

    def _speech_sse(self, req, text, fmt, speed, kw, chunk, spk, prompt,
                    prompt_text) -> Reply:
        """OpenAI ``stream_format: "sse"``: pcm16 deltas as they decode.
        Honors the server's ``--stream-share`` default (and a per-request
        ``"shared"`` override) like ``/tts/stream``: a shared client past the
        admission cap gets a 503 + Retry-After in the OpenAI envelope before
        any SSE byte."""
        if fmt not in ("wav", "pcm"):
            return _error(400, "stream_format 'sse' supports response_format"
                               " wav/pcm only (deltas are pcm frames)",
                          param="stream_format")
        tts = self.server.tts
        shared = truthy(req.get("shared", self.server.stream_share))
        release = None
        if shared:
            from ..runtime.wave import WaveOverloadedError

            try:
                release = tts.admit_shared_client()
            except WaveOverloadedError:
                return _error(503, "server at capacity (max concurrent shared "
                                   "streams reached)", err_type="server_error",
                              headers={"Retry-After": "1"})
        args = dict(spk_audio_path=spk, prompt_audio_path=prompt,
                    prompt_audio_text=prompt_text, text=text, speed=speed,
                    stream_chunk=chunk, debug=False, **kw)
        if shared:
            start = functools.partial(tts.stream_shared_async, admitted=release is not None,
                                      **args)
        else:
            start = functools.partial(tts.infer_stream_async, **args)
        return Reply(200, {"Content-Type": "text/event-stream", "Cache-Control": "no-cache",
                           "X-Accel-Buffering": "no"},
                     Stream(self._speech_sse_body(start, text), release))

    async def _speech_sse_body(self, start, text):
        t0 = time.perf_counter()
        first, total, agen = True, 0, None
        try:
            agen = start()
            async for clip in agen:
                if first:
                    self.server.timings.record("ttfa_s", time.perf_counter() - t0)
                    first = False
                total += len(clip.audio_data)
                delta = {"type": "speech.audio.delta",
                         "audio": base64.b64encode(pack_raw(clip.audio_data)).decode()}
                yield b"data: " + json.dumps(delta).encode() + b"\n\n"
            rate = self.server.tts.samplerate
            done = {"type": "speech.audio.done",
                    "usage": {"input_characters": len(text),
                              "output_duration_s": total / rate, "sample_rate": rate}}
            yield b"data: " + json.dumps(done).encode() + b"\n\n"
        except Exception as e:  # noqa: BLE001 — surface as an SSE error event
            err = {"type": "error", "error": {"message": str(e), "type": "server_error"}}
            yield b"data: " + json.dumps(err).encode() + b"\n\n"
        finally:
            if agen is not None:
                await agen.aclose()

    async def models(self, req=None) -> Reply:
        tts = self.server.tts
        data = [{"id": str(m), "object": "model", "created": self.started,
                 "owned_by": "gsv-tts-tpu"} for m in tts.get_gpt_list()]
        return json_reply({"object": "list", "data": data})

    async def voices_list(self, req=None) -> Reply:
        return json_reply({"voices": sorted(self.voices)})


def add_openai_routes(app, server, voices: Optional[Dict[str, dict]] = None) -> None:
    oai = _OpenAISpeech(server, voices)
    app["openai"] = oai
    app.router.add_post("/v1/audio/speech", handler(oai.speech, speech_body))
    app.router.add_get("/v1/models", handler(oai.models, no_body))
    app.router.add_get("/v1/audio/voices", handler(oai.voices_list, no_body))
