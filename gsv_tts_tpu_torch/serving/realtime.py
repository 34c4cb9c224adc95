"""WebRTC realtime server (counterpart of ``gsv_tts_tpu/serving/realtime.py``):
aiohttp + aiortc, datachannel JSON requests → streaming synthesis resampled to
48 kHz s16 frames on a MediaStreamTrack.

Requires ``aiohttp``, ``aiortc`` and ``av`` (optional); the module imports
without them and the functions that need them raise a clear ``ImportError``,
since the rest of the serving stack has no WebRTC dependency.
"""
from __future__ import annotations

import asyncio
import fractions
import json
import time

import numpy as np

from ..ops.stft import resample


def _require_aiohttp():
    try:
        from aiohttp import web
    except ImportError as e:
        raise ImportError("realtime serving requires `aiohttp`") from e
    return web


def _require_aiortc():
    try:
        from aiortc import RTCPeerConnection, RTCSessionDescription
        from aiortc.mediastreams import MediaStreamTrack, AudioFrame
        return RTCPeerConnection, RTCSessionDescription, MediaStreamTrack, AudioFrame
    except ImportError as e:
        raise ImportError(
            "realtime serving requires `aiortc` (pip install aiortc)") from e


OUT_RATE = 48000
SAMPLES_PER_FRAME = 960  # 20 ms at 48 kHz


def make_audio_track():
    """A MediaStreamTrack fed from an asyncio queue of float32 32 kHz audio."""
    (_, _, MediaStreamTrack, _) = _require_aiortc()
    import av

    class TTSAudioTrack(MediaStreamTrack):
        kind = "audio"

        def __init__(self):
            super().__init__()
            self.queue: asyncio.Queue = asyncio.Queue()
            self._buffer = np.zeros(0, np.int16)
            self._timestamp = 0
            self._start: float = None  # wall-clock origin for pacing

        async def put_audio(self, clip):
            audio48 = resample(np.asarray(clip.audio_data, np.float32),
                               clip.samplerate, OUT_RATE)
            pcm = (np.clip(audio48, -1, 1) * 32767).astype(np.int16)
            await self.queue.put(pcm)

        async def recv(self):
            # real-time pacing (reference ``realtime_api.py:75-119`` sends
            # one 20 ms frame per 20 ms): without it, queued synthesis
            # audio is blasted faster than realtime and the receiver's
            # jitter buffer drops it; idle silence likewise must tick at
            # the frame rate, not every poll
            loop = asyncio.get_event_loop()
            if self._start is None:
                self._start = loop.time()
            due = self._start + self._timestamp / OUT_RATE
            delay = due - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)

            while len(self._buffer) < SAMPLES_PER_FRAME:
                try:
                    # wait one frame period for more audio, then pad: a
                    # PARTIAL buffer with an idle queue previously spun
                    # forever and the final chunk of every utterance was
                    # never flushed
                    pcm = await asyncio.wait_for(self.queue.get(),
                                                 timeout=0.02)
                    self._buffer = np.concatenate([self._buffer, pcm])
                except asyncio.TimeoutError:
                    pad = SAMPLES_PER_FRAME - len(self._buffer)
                    self._buffer = np.concatenate(
                        [self._buffer, np.zeros(pad, np.int16)])

            chunk = self._buffer[:SAMPLES_PER_FRAME]
            self._buffer = self._buffer[SAMPLES_PER_FRAME:]
            frame = av.AudioFrame.from_ndarray(chunk[None], format="s16",
                                               layout="mono")
            frame.sample_rate = OUT_RATE
            frame.pts = self._timestamp
            frame.time_base = fractions.Fraction(1, OUT_RATE)
            self._timestamp += SAMPLES_PER_FRAME
            return frame

    return TTSAudioTrack()


def create_realtime_app(tts):
    web = _require_aiohttp()
    RTCPeerConnection, RTCSessionDescription, _, _ = _require_aiortc()
    pcs = set()

    async def handle_offer(request):
        params = await request.json()
        offer = RTCSessionDescription(sdp=params["sdp"], type=params["type"])
        pc = RTCPeerConnection()
        pcs.add(pc)
        track = make_audio_track()
        pc.addTrack(track)

        @pc.on("connectionstatechange")
        async def on_state():
            if pc.connectionState in ("failed", "closed"):
                await pc.close()
                pcs.discard(pc)

        @pc.on("datachannel")
        def on_datachannel(channel):
            @channel.on("message")
            def on_message(message):
                req = json.loads(message)

                async def generate():
                    t0 = time.perf_counter()
                    first = True
                    async for clip in tts.infer_stream_async(
                            spk_audio_path=req["speaker_audio"],
                            prompt_audio_path=req["prompt_audio"],
                            prompt_audio_text=req.get("prompt_text", ""),
                            text=req["text"],
                            stream_chunk=int(req.get("stream_chunk", 25)),
                            debug=False):
                        if first:
                            channel.send(json.dumps(
                                {"event": "first_audio",
                                 "latency_ms": (time.perf_counter() - t0) * 1000}))
                            first = False
                        await track.put_audio(clip)
                    channel.send(json.dumps({"event": "done"}))

                asyncio.ensure_future(generate())

        await pc.setRemoteDescription(offer)
        answer = await pc.createAnswer()
        await pc.setLocalDescription(answer)
        return web.json_response({"sdp": pc.localDescription.sdp,
                                  "type": pc.localDescription.type})

    async def on_shutdown(app):
        await asyncio.gather(*[pc.close() for pc in pcs])
        pcs.clear()

    app = web.Application()
    app.router.add_post("/offer", handle_offer)
    app.on_shutdown.append(on_shutdown)
    return app


def main():
    import argparse

    from ..tts import TTS
    from .server import DEVICE_HELP, engine_device

    ap = argparse.ArgumentParser(
        description="gsv-tts-lite WebRTC realtime server on the PyTorch port")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=9881)
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--gpt", default=None)
    ap.add_argument("--sovits", default=None)
    ap.add_argument("--device", default=None, help=DEVICE_HELP)
    ap.add_argument("--quant-t2s", nargs="?", const="int8", default=False,
                    choices=("int8", "int4"),
                    help="quantized weight-streaming GPT decode (see the HTTP "
                         "server's flag of the same name)")
    args = ap.parse_args()

    web = _require_aiohttp()
    tts = TTS(models_dir=args.models_dir, device=engine_device(args.device), quant_t2s=args.quant_t2s)
    if args.gpt:
        tts.load_gpt_model(args.gpt)
    if args.sovits:
        tts.load_sovits_model(args.sovits)
    web.run_app(create_realtime_app(tts), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
