"""Open-ended streaming continuous batching: the wave scheduler (counterpart
of ``gsv_tts_tpu/runtime/wave.py``).

``T2SEngine.generate_batched_stream`` takes every request up front: one
caller owns the wave.  Serving has N independent streaming clients that
arrive at different times (the reference serializes them behind
``_infer_lock``, ``TTS.py:145``).  This module runs the same slot machinery
(``prefill_batch`` / ``prefill_slots`` / ``prefill_slot`` / ``decode_chunk``)
as an attach/detach service:

* :meth:`WaveScheduler.attach` may be called from any thread at any time; it
  returns a :class:`StreamHandle` that yields the request's semantic tokens
  as they become final (the emission rule of ``generate_batched_stream``:
  the prefill's sample and each chunk's last sample are held back, nothing
  past a sampled EOS is emitted).
* One decode thread owns the device state and runs decode chunks while any
  slot is live.  New requests are prefilled into free slots of the running
  wave (the reference's slot refill, ``t2s_model.py:696-722``, across
  independent clients).  A chunk of a wave of 2..8 slots runs K2, of one
  slot K1 (``runtime/t2s_session.py:step_path``).
* The wave grows to the next ``gpt_cache`` batch bucket when requests queue
  and no slot is free, and when at most half its slots are live it compacts
  the survivors into the smallest bucket that holds them
  (``T2SEngine._gather_live``: one gather on the device, no new prefill), so
  a lone tail decodes at the one-slot kernel's rate.

Requests are grouped into waves by sampling signature (top_k, top_p,
temperature and repetition_penalty apply wave-wide, as in the reference's
batched mode); waves of distinct signatures take turns on the card.

Randomness is an input, as everywhere in this package: each wave owns a
``torch.Generator`` seeded from the scheduler's ``np.random.RandomState(seed)``
(where the JAX scheduler seeds its ``PRNGKey``), and every prefill and every
chunk draws its Gumbel tensor from it.  Each pump runs inside the facade's
``DeviceGate`` shared section (``gate``), so a SoVITS graph capture in another
thread never runs beside a K1 / K2 launch.
"""
from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .t2s_session import (SampleArgs, SlotHarvest, T2SEngine, decode_chunk, freeze_slot,
                          prefill_batch, prompt_rows, step_path)

__all__ = ["WaveScheduler", "StreamHandle", "WaveOverloadedError"]

logger = logging.getLogger(__name__)


class WaveOverloadedError(RuntimeError):
    """Raised by :meth:`WaveScheduler.acquire_client` when the scheduler
    already serves ``max_clients`` streaming clients (serving answers it with
    HTTP 503 and ``Retry-After``)."""


class StreamHandle:
    """Consumer side of one attached request.

    Iterate to receive ``(np.int64 tokens, done)``; iteration ends when the
    request finishes.  Thread-safe; ``cancel()`` detaches the request (its
    slot is freed at the scheduler's next round)."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._cancelled = threading.Event()
        self.done = False

    # -- producer (scheduler) side --------------------------------------
    def _emit(self, tokens: np.ndarray, done: bool):
        self._q.put(("tok", tokens, done))

    def _fail(self, exc: BaseException):
        self._q.put(("err", exc, True))

    # -- consumer side ---------------------------------------------------
    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self):
        """Detach: the slot is freed at the next round and no further tokens
        are emitted (a client disconnect)."""
        self._cancelled.set()
        self._q.put(("tok", np.zeros(0, np.int64), True))

    def get(self, timeout: Optional[float] = None) -> Tuple[np.ndarray, bool]:
        """The next ``(tokens, done)`` event; raises the scheduler's error for
        a failed request, ``queue.Empty`` after ``timeout`` seconds."""
        kind, payload, done = self._q.get(timeout=timeout)
        if kind == "err":
            raise payload
        return payload, done

    def __iter__(self):
        while True:
            tokens, done = self.get()
            yield tokens, done
            if done:
                self.done = True
                return


class _Slot:
    __slots__ = ("handle", "harvest", "live")

    def __init__(self, handle: Optional[StreamHandle] = None):
        self.handle = handle
        self.harvest = SlotHarvest()
        self.live = handle is not None


class _Request:
    __slots__ = ("x", "y", "bert", "handle")

    def __init__(self, x, y, bert, handle):
        self.x = x
        self.y = y
        self.bert = bert
        self.handle = handle


class _Wave:
    def __init__(self, sa: SampleArgs, generator: torch.Generator):
        self.sa = sa
        self.generator = generator  # every Gumbel draw of this wave
        self.state = None           # DecodeState, or None between generations
        self.slots: List[_Slot] = []
        self.pending: "deque[_Request]" = deque()
        self.first_chunk = True
        # counters (WaveScheduler.stats)
        self.n_attached = 0
        self.n_finished = 0
        self.n_refills = 0
        self.n_batched_refills = 0
        self.n_resizes = 0


class WaveScheduler:
    """Serving-side continuous batching over one :class:`T2SEngine`.

    One instance per loaded GPT model; clients on any thread call
    :meth:`attach` and consume the returned handle.  ``max_batch`` caps the
    wave's batch bucket; ``max_clients`` caps the concurrent streaming
    clients (``None``: no cap); ``gate`` is the facade's ``DeviceGate``, in
    whose shared section every pump runs (``None``: none).  ``totals`` counts, over the scheduler's life,
    decode steps by kernel path (``k1_steps``, ``k2_steps``, ``k1q_steps``,
    ``k2q_steps``, ``generic_steps``), ``slot_steps``, ``tokens`` emitted,
    ``decode_s`` (host seconds of the chunks, each ending in a read-back),
    ``k2_s`` (those of K2 chunks) and ``max_live`` (the most live slots one
    chunk decoded)."""

    def __init__(self, engine: T2SEngine, max_batch: int = 4, seed: int = 0,
                 max_clients: Optional[int] = None, gate=None):
        if engine.mesh is not None:
            # clients arrive on each rank's threads at their own times: the ranks'
            # host loops would part, and their collectives wait on each other
            raise ValueError("the shared wave runs one card's engine; a sharded engine "
                             "(T2SEngine.shard, DataParallelEngine) cannot drive it")
        self.engine = engine
        self.max_batch = min(max_batch, sorted(engine.buckets)[-1])
        self.max_clients = max_clients
        self._gate = gate
        self._n_clients = 0
        self._waves: Dict[Tuple, _Wave] = {}
        self._lock = threading.Lock()
        self._work = threading.Event()
        self._closed = False
        self._seed_rng = np.random.RandomState(seed)
        self.totals = {"decode_steps": 0, "slot_steps": 0, "tokens": 0, "k1_steps": 0,
                       "k2_steps": 0, "k1q_steps": 0, "k2q_steps": 0, "generic_steps": 0,
                       "decode_s": 0.0, "k2_s": 0.0, "max_live": 0}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gsv-wave-scheduler")
        self._thread.start()

    # ------------------------------------------------------------------
    # client surface
    # ------------------------------------------------------------------

    def attach(self, x_ids, y_ids, bert, top_k: int = 15, top_p: float = 1.0,
               temperature: float = 1.0, repetition_penalty: float = 1.35) -> StreamHandle:
        """Register one request; returns its :class:`StreamHandle`.  Raises
        ``ValueError`` at once when the prompt's padded cache need fits no
        ``gpt_cache`` bucket at a batch size this scheduler uses."""
        x = np.asarray(x_ids, np.int64).reshape(-1)
        y = np.asarray(y_ids, np.int64).reshape(-1)
        b = np.asarray(bert, np.float32).reshape(len(x), -1)
        # the prefill writes the PADDED [Lx|Ly] block and generation needs one
        # row of headroom: guard on that need, over the buckets the waves use
        need = prompt_rows(x, y)
        if not any(self._pick_S(bb, need - 1) is not None for bb in self._bucket_sizes()):
            raise ValueError(f"prompt length {len(x) + len(y)} (padded cache need {need}) "
                             f"exceeds every gpt_cache bucket at batch <= {self.max_batch}")
        # batched-mode sampling: wave-wide arguments, no repetition penalty
        # over generated tokens (reference ``t2s_model.py:651``)
        sa = SampleArgs(top_k=int(top_k), top_p=float(top_p), temperature=float(temperature),
                        repetition_penalty=float(repetition_penalty), use_prev=False)
        handle = StreamHandle()
        sig = (sa.top_k, sa.top_p, sa.temperature, sa.repetition_penalty)
        with self._lock:
            # under close()'s lock: a racing attach fails here or is seen by
            # close()'s sweep of the pending requests
            if self._closed:
                raise RuntimeError("WaveScheduler is closed")
            wave = self._waves.get(sig)
            if wave is None:
                gen = torch.Generator(device=self.engine.device)
                gen.manual_seed(int(self._seed_rng.randint(0, 2 ** 31 - 1)))
                wave = self._waves[sig] = _Wave(sa, gen)
            wave.pending.append(_Request(x, y, b, handle))
            wave.n_attached += 1
        self._work.set()
        return handle

    def acquire_client(self) -> None:
        """Admission: claim one client slot (once per streaming client, for
        its whole multi-segment life).  Raises :class:`WaveOverloadedError`
        at the ``max_clients`` cap."""
        with self._lock:
            if self._closed:
                raise RuntimeError("WaveScheduler is closed")
            if self.max_clients is not None and self._n_clients >= self.max_clients:
                raise WaveOverloadedError(f"{self._n_clients} active streaming clients "
                                          f"(max_clients={self.max_clients})")
            self._n_clients += 1

    def release_client(self) -> None:
        with self._lock:
            self._n_clients = max(0, self._n_clients - 1)

    @property
    def overloaded(self) -> bool:
        """True when a new :meth:`acquire_client` would be refused (advisory:
        the acquire itself decides)."""
        with self._lock:
            return self.max_clients is not None and self._n_clients >= self.max_clients

    def close(self):
        """Stop the decode thread and fail every pending and live request."""
        with self._lock:
            self._closed = True
        self._work.set()
        self._thread.join(timeout=30.0)
        with self._lock:
            for wave in self._waves.values():
                for req in wave.pending:
                    req.handle._fail(RuntimeError("WaveScheduler closed"))
                for slot in wave.slots:
                    if slot.live and slot.handle is not None:
                        slot.handle._fail(RuntimeError("WaveScheduler closed"))
            self._waves.clear()

    @property
    def stats(self) -> Dict:
        with self._lock:
            waves = [{"signature": list(sig), "batch": len(w.slots),
                      "live": sum(1 for s in w.slots if s.live), "pending": len(w.pending),
                      "attached": w.n_attached, "finished": w.n_finished,
                      "refills": w.n_refills, "batched_refills": w.n_batched_refills,
                      "resizes": w.n_resizes}
                     for sig, w in self._waves.items()]
            return {"waves": waves, "max_batch": self.max_batch, "clients": self._n_clients,
                    "max_clients": self.max_clients, "totals": dict(self.totals)}

    # ------------------------------------------------------------------
    # decode thread
    # ------------------------------------------------------------------

    def _device(self):
        return self._gate.shared() if self._gate is not None else contextlib.nullcontext()

    def _run(self):
        torch.set_grad_enabled(False)  # grad mode is per thread
        while not self._closed:
            progressed = False
            with self._lock:
                waves = list(self._waves.values())
            for wave in waves:
                try:
                    with self._device():
                        progressed |= self._pump(wave)
                except Exception as exc:  # noqa: BLE001 — fails the wave's clients
                    logger.exception("wave scheduler failure")
                    # only the installed streams: popped requests were failed
                    # where they were popped, pending ones go to the next wave
                    for slot in wave.slots:
                        if slot.live and slot.handle is not None:
                            slot.handle._fail(exc)
                            slot.live = False
                    wave.state = None
                    wave.slots = []
            # clear the work event BEFORE the idleness check, so that an
            # attach between the two is not lost
            if not progressed:
                self._work.clear()
            with self._lock:
                for sig in [s for s, w in self._waves.items()
                            if w.state is None and not w.pending]:
                    del self._waves[sig]
                idle = not any(w.pending or any(s.live for s in w.slots)
                               for w in self._waves.values())
            if not progressed and idle:
                self._work.wait(timeout=0.2)

    # -- wave mechanics --------------------------------------------------

    def _bucket_sizes(self) -> List[int]:
        return (sorted(b for b in self.engine.buckets if b <= self.max_batch)
                or [sorted(self.engine.buckets)[0]])

    def _pick_B(self, n: int) -> int:
        sizes = self._bucket_sizes()
        return next((b for b in sizes if b >= n), sizes[-1])

    def _pick_S(self, B: int, needed: int) -> Optional[int]:
        return next((s for s in self.engine.buckets[B] if s > needed), None)

    def _take_pending(self, wave: _Wave, k: int) -> List[_Request]:
        out = []
        with self._lock:
            while wave.pending and len(out) < k:
                req = wave.pending.popleft()
                if not req.handle.cancelled:
                    out.append(req)
        return out

    def _create_wave_state(self, wave: _Wave) -> bool:
        """First prefill of a wave: padded common-shape prompts, dummy 1/1
        prompts in the dead slots (``generate_batched_stream``'s)."""
        with self._lock:
            n_wait = len(wave.pending)
        B = self._pick_B(max(1, n_wait))
        reqs = self._take_pending(wave, B)
        if not reqs:
            return False
        try:
            return self._create_wave_state_for(wave, reqs, B)
        except Exception as exc:
            # popped requests are neither pending nor installed: fail them
            # here, or their handles (and their clients) wait forever
            for r in reqs:
                r.handle._fail(exc)
            raise

    def _create_wave_state_for(self, wave: _Wave, reqs: List[_Request], B: int) -> bool:
        eng = self.engine
        xs, ys, bs, x_lens, y_lens = eng._pad_prompts([(r.x, r.y, r.bert) for r in reqs], B)
        S = self._pick_S(B, max(int((x_lens + y_lens).max()), xs.shape[1] + ys.shape[1] - 1))
        if S is None:
            # no S bucket at this B holds the group's padded prompt: requeue
            # and open the wave with the head request alone at a batch size
            # that fits it (attach's guard promises one); ``reqs`` changes in
            # place so the caller's error path fails exactly what is in hand
            with self._lock:
                for r in reversed(reqs):
                    wave.pending.appendleft(r)
            reqs.clear()
            reqs.extend(self._take_pending(wave, 1))
            if not reqs:
                return False
            r0 = reqs[0]
            need = prompt_rows(r0.x, r0.y)
            fit = next((b for b in self._bucket_sizes()
                        if self._pick_S(b, need - 1) is not None), None)
            if fit is None:  # attach's guard rules this out
                r0.handle._fail(ValueError("prompt fits no gpt_cache bucket"))
                return True
            B = fit
            xs, ys, bs, x_lens, y_lens = eng._pad_prompts([(r0.x, r0.y, r0.bert)], B)
            S = self._pick_S(B, max(len(r0.x) + len(r0.y), xs.shape[1] + ys.shape[1] - 1))
        k_cache, v_cache = eng._alloc_cache(B, S)
        state, _ = prefill_batch(
            eng.params, eng.cfg, *eng._dev(xs, ys, bs, x_lens, y_lens), k_cache, v_cache,
            eng._noise(wave.generator, B, eng.cfg.vocab_size), wave.sa, False, eng.dtype,
            eng.attn_impl)
        wave.state = state
        wave.slots = [_Slot(r.handle) for r in reqs] + [_Slot() for _ in range(B - len(reqs))]
        for j in range(len(reqs), B):  # the dummy slots stay frozen
            freeze_slot(wave.state, j)
        wave.first_chunk = True
        return True

    def _refill(self, wave: _Wave, jobs: List[Tuple[int, _Request]]) -> bool:
        """Prefill each ``(slot, request)`` job: one batched pass when several
        arrive together (``T2SEngine._refill_slots_prefill``), escalating the
        cache's length bucket as needed.  A request that fits no bucket at
        this batch size is requeued with everything behind it (FIFO kept;
        they are admitted when the wave re-forms) and False returned."""
        eng = self.engine
        S_cur = wave.state.k_cache.shape[2]
        S_max = max(eng.buckets[len(wave.slots)])
        admit: List[Tuple[int, _Request]] = []
        for n, (j, req) in enumerate(jobs):
            if prompt_rows(req.x, req.y) > S_max:
                with self._lock:
                    for _, r in reversed(jobs[n:]):
                        wave.pending.appendleft(r)
                break
            admit.append((j, req))
        if not admit:
            return False
        try:
            state, batched = eng._refill_slots_prefill(
                wave.state, [j for j, _ in admit], [(r.x, r.y, r.bert) for _, r in admit],
                wave.sa, wave.generator)
        except Exception as exc:
            for _, r in admit:  # popped, not installed: fail them here
                r.handle._fail(exc)
            raise
        if state.k_cache.shape[2] != S_cur:
            wave.n_resizes += 1
        if batched:
            wave.n_batched_refills += 1
        wave.state = state
        for j, req in admit:
            wave.slots[j] = _Slot(req.handle)
            wave.n_refills += 1
        return len(admit) == len(jobs)

    def _resize(self, wave: _Wave, new_B: int) -> bool:
        """Gather the live slots into a ``new_B``-slot wave (growth or
        compaction).  False when no S bucket at ``new_B`` holds them."""
        live_idx = [j for j, s in enumerate(wave.slots) if s.live]
        new_state = self.engine._gather_live(wave.state, live_idx, new_B)
        if new_state is None:
            return False
        new_slots = [wave.slots[old] for old in live_idx[:new_B]]
        wave.state = new_state
        wave.slots = new_slots + [_Slot() for _ in range(new_B - len(new_slots))]
        wave.n_resizes += 1
        return True

    def _pump(self, wave: _Wave) -> bool:
        eng = self.engine
        cfg = eng.cfg

        # 0. cancels first, before spending device time
        for j, slot in enumerate(wave.slots):
            if slot.live and slot.handle.cancelled:
                slot.live = False
                freeze_slot(wave.state, j)
                wave.n_finished += 1

        # a wave with no live slot starts afresh: new arrivals get a fresh
        # wave's cadence (a 1-step first chunk) and bucket sizing
        if wave.state is not None and not any(s.live for s in wave.slots):
            wave.state = None
            wave.slots = []
            wave.first_chunk = True

        live = [j for j, s in enumerate(wave.slots) if s.live]
        with self._lock:
            n_wait = len(wave.pending)

        # 1. admission
        if wave.state is None:
            if not n_wait or not self._create_wave_state(wave):
                return False
        else:
            free = [j for j, s in enumerate(wave.slots) if not s.live]
            if n_wait and not free:
                # grow to the batch bucket that fits live + waiting
                target = self._pick_B(min(len(live) + n_wait, self.max_batch))
                if target > len(wave.slots):
                    self._resize(wave, target)
                    free = [j for j, s in enumerate(wave.slots) if not s.live]
            jobs: List[Tuple[int, _Request]] = []
            for j in free:
                got = self._take_pending(wave, 1)
                if not got:
                    break
                jobs.append((j, got[0]))
            if jobs:
                self._refill(wave, jobs)

        live = [j for j, s in enumerate(wave.slots) if s.live]
        if not live:
            wave.state = None
            wave.slots = []
            return True

        # 2. compaction: a mostly dead wave re-packs into the smallest bucket
        #    that holds the survivors
        B = len(wave.slots)
        if len(live) <= B // 2:
            target = self._pick_B(len(live))
            if target < B:
                self._resize(wave, target)
                live = [j for j, s in enumerate(wave.slots) if s.live]
                B = len(wave.slots)

        # 3. length-bucket escalation, edge clamp, dead-slot refreeze: the
        #    engine's one definition, shared with generate_batched_stream
        n_steps = 1 if wave.first_chunk else eng.check_interval
        wave.first_chunk = False
        wave.state, n_steps, S_cur = eng._prepare_chunk(wave.state, [s.live for s in wave.slots],
                                                        n_steps)

        # 4. one decode chunk for the whole wave
        t0 = time.perf_counter()
        wave.state, toks = decode_chunk(
            eng.params, cfg, wave.state, n_steps, wave.sa,
            eng._noise(wave.generator, n_steps, B, cfg.vocab_size), 0, eng.dtype, eng.attn_impl)
        toks = toks.cpu().numpy()  # [B, n_steps]
        kv = wave.state.kv_len.cpu().numpy()
        eng._check_kernels()
        seconds = time.perf_counter() - t0
        path = step_path(eng.attn_impl, B)
        with self._lock:
            t = self.totals
            t["decode_steps"] += n_steps
            t["slot_steps"] += n_steps * B
            t[path + "_steps"] += n_steps
            t["decode_s"] += seconds
            if path == "k2":
                t["k2_s"] += seconds
            t["max_live"] = max(t["max_live"], len(live))

        # 5. harvest and emit (generate_batched_stream's window: samples[:-1],
        #    cut at EOS); the totals count the tokens before their clients see them
        emits = []
        for j in live:
            slot = wave.slots[j]
            slot.harvest.extend(toks[j])
            if slot.handle.cancelled:
                continue  # frozen at the next round's cancel pass
            out = slot.harvest.drain_stream(cfg.eos)
            if out is not None:
                emits.append((slot.handle, out, False))
            if not eng._retire_after_chunk(int(toks[j][-1]), int(kv[j]), B, S_cur):
                continue
            emits.append((slot.handle, slot.harvest.drain_final(cfg.eos), True))
            slot.live = False
            wave.n_finished += 1
            freeze_slot(wave.state, j)
        with self._lock:
            self.totals["tokens"] += sum(out.size for _, out, _ in emits)
        for handle, out, done in emits:
            handle._emit(out, done)
        return True
