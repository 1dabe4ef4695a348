"""The compute pipeline: host buffer pool feeding asynchronous device steps.

Device-side redesign of the reference's ``Datastore``
(/root/reference/src/datastore.{h,cxx}).  The shape is the same —
a bounded pool of reusable byte buffers connecting an acquisition producer
to a spectral consumer, with backpressure and a queue-depth histogram —
but the consumer is not a CPU FFT loop: it slices buffers into fixed-shape
frame batches and dispatches ONE jitted device step per batch
(dequant → window → batched FFT → masked |X|² partial sum).  JAX's async
dispatch pipelines host slicing, host↔device transfer and device compute;
a small in-flight window bounds device memory.

Reference-parity details preserved:
* producer blocks when no buffer is free; the number of free buffers is
  histogrammed at every grab (acquisition.cxx:278-285, the documented
  "first number nonzero ⇒ compute too slow" diagnostic);
* frames carry across buffer boundaries (FrameSlicer);
* processing stops at exactly ``repeats`` frames (datastore.cxx:67);
* partial sums accumulate into float64 on the host — matching the
  reference's double accumulator (datastore.h:53) without device f64.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, List, Optional

import numpy as np

from ..config import Params
from ..ops.spectral import FrameSlicer, PsdStep


@dataclasses.dataclass
class AcquisitionResult:
    pwr: np.ndarray            # (N,) float64, unshifted bins
    repeats_done: int
    #: Σ|X|⁴ second moment (only with a two-moment step, e.g. --sk-file).
    pwr2: Optional[np.ndarray] = None
    #: SK-excised accumulator and per-bin kept-spectra counts (only with
    #: an excising step, --sk-excise).
    pwr_clean: Optional[np.ndarray] = None
    kept: Optional[np.ndarray] = None


def welch_hop(N: int, overlap_percent: float) -> Optional[int]:
    """Frame hop for Welch-overlap mode (None = back-to-back frames) —
    the ONE definition shared by the single-stream Datastore and the
    multistream engine."""
    if overlap_percent <= 0.0:
        return None
    return max(1, int(round(N * (1.0 - overlap_percent / 100.0))))


def stream_bytes_needed(N: int, hop: Optional[int], repeats: int) -> int:
    """Stream bytes one acquisition must read for ``repeats`` frames:
    the reference's 2·N·repeats (acquisition.cxx:273) without overlap;
    with a hop < N overlapping frames reuse samples, so only
    2·(hop·(repeats−1) + N) unique bytes are needed."""
    if hop is None or repeats <= 0:
        return 2 * N * repeats
    return 2 * (hop * (repeats - 1) + N)


def unique_complex_samples(N: int, hop: Optional[int],
                           repeats_done: int) -> int:
    """Unique (complex) input samples consumed by ``repeats_done``
    frames: N·repeats_done normally, hop·(repeats_done−1)+N with Welch
    overlap — the honest basis for effective integration time
    (acquisition.cxx:356-357 divides samples by the sample rate)."""
    if repeats_done <= 0:
        return 0
    if hop is None:
        return N * repeats_done
    return hop * (repeats_done - 1) + N


def print_queue_histogram(histogram, stderr=None) -> None:
    """datastore.cxx:98-103 — shared by both pipeline engines so the
    documented diagnostic format cannot drift."""
    import sys
    err = stderr if stderr is not None else sys.stderr
    print("Buffer queue histogram: "
          + " ".join(str(v) for v in histogram) + " ", file=err)


class _ShardedTransformStep:
    """Adapter giving parallel.bigfft the PsdStep calling convention
    (.F + __call__(frames_u8, n_valid) -> async (N,) device partial)."""

    def __init__(self, N: int, frames_per_step: int, window):
        from ..exceptions import ReturnValue, RPFexception
        from ..parallel.bigfft import ShardedLargeFFTPsd
        from ..parallel.mesh import make_mesh
        try:
            self._impl = ShardedLargeFFTPsd(make_mesh(), N, frames_per_step,
                                            window=window)
        except ValueError as e:
            # e.g. the mesh size does not divide the four-step factors —
            # a configuration problem, so the typed CLI exit (3), not a
            # traceback.
            raise RPFexception(f"--shard-transform: {e}. Exiting.",
                               ReturnValue.InvalidArgument)
        self.F = frames_per_step
        #: same introspection contract as PsdStep.path — the distributed
        #: four-step is its own rung.
        self.path = "bigfft"

    def __call__(self, frames_u8: np.ndarray, n_valid: int):
        return self._impl.device_step(frames_u8, n_valid)


class Datastore:
    """Buffer pool + device-step consumer.

    One instance is reused across all hops of a session (like the
    reference's single Datastore constructed at rtl_power_fftw.cxx:112),
    so the jitted step compiles once.
    """

    def __init__(self, params: Params, window: Optional[np.ndarray] = None,
                 max_in_flight: int = 4):
        self.params = params
        self.N = params.N
        hop = welch_hop(params.N, params.welch_overlap)
        self._hop = hop

        frames_per_step = params.frames_per_step
        if frames_per_step <= 0:
            # Default: one buffer's worth of frames per device step, capped
            # to keep step latency and padding waste balanced.
            frames_per_step = max(1, min(params.buf_length // (2 * params.N), 4096))
        if getattr(params, "pfb_taps", 0) > 1:
            # Polyphase-filterbank estimator (--pfb-taps): same step
            # contract, plus per-acquisition history reset (see
            # begin_acquisition). The (N,) window array is deliberately
            # ignored here — the PFB's windowed-sinc PROTOTYPE subsumes
            # it; --window-function names the prototype's window and
            # parse_args rejects -w window files with --pfb-taps.
            from ..models.pfb import PfbSessionStep
            self.step = PfbSessionStep(
                params.N, frames_per_step, taps=params.pfb_taps,
                window=params.window_function or "hann")
        elif getattr(params, "multitaper", 0) >= 1:
            # Thomson multitaper estimator (--multitaper K): stateless
            # PsdStep-contract step averaging K DPSS eigenspectra per
            # frame. parse_args rejects -w/--window-function with it
            # (the tapers replace the window), so `window` is None here.
            from ..models.multitaper import MultitaperSessionStep
            self.step = MultitaperSessionStep(
                params.N, frames_per_step, K=params.multitaper,
                NW=params.time_bandwidth,
                precision=getattr(params, "precision", "highest"))
        elif (getattr(params, "sk_file", "")
                or getattr(params, "sk_excise", 0.0) > 0.0):
            # Spectral-kurtosis paths (--sk-file / --sk-excise): the step
            # accumulates BOTH moments; s1 doubles as the ordinary PSD
            # accumulator so the unexcised spectrum is unchanged. With
            # --sk-excise it also returns the per-block SK-gated clean
            # accumulator and per-bin kept counts.
            from ..models.kurtosis import SkSessionStep
            self.step = SkSessionStep(
                params.N, frames_per_step, window=window,
                backend=params.fft_backend,
                excise_sigma=getattr(params, "sk_excise", 0.0))
        elif (getattr(params, "shard_transform", False)
                and params.streams <= 1):
            # Sequence parallelism: each transform sharded over the device
            # mesh (distributed four-step FFT, parallel/bigfft.py) instead
            # of a per-device batched step. Same (F, 2N) u8 -> (N,) f32
            # partial-power contract as PsdStep. (With --streams > 1 the
            # flag belongs to MultiStreamAcquisition's 2-D grid step —
            # parallel/grid.py — and this Datastore stays a plain
            # single-stream fallback that the session loop won't drive.)
            self.step = _ShardedTransformStep(params.N, frames_per_step,
                                              window)
        else:
            self.step = PsdStep(params.N, frames_per_step, window=window,
                                backend=params.fft_backend,
                                precision=params.precision)
        self.slicer = FrameSlicer(params.N, hop=hop)
        self.max_in_flight = max_in_flight

        # Buffer pool bookkeeping (datastore.h:40-47). Buffers here are just
        # numpy arrays owned by the queue; the pool bound provides the
        # backpressure and the histogram provides the diagnostics.
        self.n_buffers = params.buffers
        self.queue_histogram: List[int] = [0] * (params.buffers + 1)
        self._occupied: Deque[np.ndarray] = collections.deque()
        self._lock = threading.Lock()
        self._status_change = threading.Condition(self._lock)
        self._acquisition_finished = False

        # Accumulator state (reset per acquisition). Steps may return a
        # TUPLE of (N,) partials named by .fields (default the single
        # first-moment "s1"); each gets its own float64 host accumulator.
        self.fields = getattr(self.step, "fields", ("s1",))
        self._acc = {f: np.zeros(self.N, dtype=np.float64)
                     for f in self.fields}
        self.repeats_done = 0
        self._consumer: Optional[threading.Thread] = None
        self._consumer_error: Optional[BaseException] = None

    # --- producer interface (called by Acquisition) ---

    @property
    def transform_path(self) -> str:
        """Which ladder rung the device step runs ("hybrid" |
        "fourstep" | "fft4" | "bigfft" | "xla" | estimator names) —
        surfaced in the verbose banner and --stats-json records. A LIVE
        view: a mid-run compile fallback that rebuilds the step on the
        matmul DFT updates it."""
        return getattr(self.step, "path", "xla")

    def bytes_needed(self) -> int:
        """Stream bytes one acquisition must read for ``repeats`` frames
        (shared formula: stream_bytes_needed). Reading the full
        non-overlapped amount in Welch mode would leave the tail
        accumulating in the slicer carry (quadratic copying)."""
        return stream_bytes_needed(self.N, self._hop, self.params.repeats)

    def unique_samples(self, repeats_done: int) -> int:
        """Unique (complex) input samples consumed by ``repeats_done``
        frames (shared formula: unique_complex_samples)."""
        return unique_complex_samples(self.N, self._hop, repeats_done)

    def begin_acquisition(self) -> None:
        """Reset accumulator and start the consumer thread (the reference
        spawns fftThread per acquisition, acquisition.cxx:256).

        Sanitizes state an ABORTED acquisition may have left behind (a
        producer-side error path that never reached finish_acquisition):
        a still-alive previous consumer is signalled and joined, and
        stale un-consumed buffers are dropped — otherwise a library
        caller reusing the Datastore would race two consumers on the
        shared accumulators and leak the failed hop's IQ into the next
        spectrum."""
        if self._consumer is not None and self._consumer.is_alive():
            with self._status_change:
                self._acquisition_finished = True
                self._occupied.clear()
                self._status_change.notify_all()
            self._consumer.join()
        self._occupied.clear()
        self._acc = {f: np.zeros(self.N, dtype=np.float64)
                     for f in self.fields}
        self.repeats_done = 0
        self.slicer.reset()
        reset = getattr(self.step, "reset", None)
        if reset is not None:
            reset()  # stateful steps (PFB history) must not leak across retunes
        self._acquisition_finished = False
        self._consumer_error = None
        self._consumer = threading.Thread(target=self._consume, daemon=True)
        self._consumer.start()

    def acquire_slot(self) -> None:
        """Block until a pool slot is free; histogram the free count
        (acquisition.cxx:278-285). Re-raises a consumer failure instead of
        deadlocking the producer against a dead consumer."""
        with self._status_change:
            free = self.n_buffers - len(self._occupied)
            self.queue_histogram[max(0, min(free, self.n_buffers))] += 1
            while (self.n_buffers - len(self._occupied) <= 0
                   and self._consumer_error is None):
                self._status_change.wait()
            if self._consumer_error is not None:
                raise self._consumer_error

    def push_buffer(self, data: np.ndarray) -> None:
        """Producer hands over a filled buffer (acquisition.cxx:317-324)."""
        with self._status_change:
            self._occupied.append(data)
            self._status_change.notify_all()

    def finish_acquisition(self) -> AcquisitionResult:
        """Signal end-of-data and join the consumer
        (acquisition.cxx:343-347)."""
        with self._status_change:
            self._acquisition_finished = True
            self._status_change.notify_all()
        assert self._consumer is not None
        self._consumer.join()
        if self._consumer_error is not None:
            raise self._consumer_error
        return AcquisitionResult(
            pwr=self._acc["s1"], repeats_done=self.repeats_done,
            pwr2=self._acc.get("s2"),
            pwr_clean=self._acc.get("s1_clean"),
            kept=self._acc.get("kept"))

    # --- consumer (device dispatch) ---

    def _consume(self) -> None:
        try:
            pending: Deque = collections.deque()  # in-flight device partials

            fields = self.fields
            acc = self._acc

            def drain(to_len: int) -> None:
                while len(pending) > to_len:
                    partial = pending.popleft()
                    # np.asarray blocks until the device step is done.
                    if len(fields) == 1:
                        acc["s1"] += np.asarray(partial, dtype=np.float64)
                    else:
                        for name, arr in zip(fields, partial):
                            acc[name] += np.asarray(arr, dtype=np.float64)

            F = self.step.F
            frame_bytes = 2 * self.N
            staging = np.zeros((F, frame_bytes), dtype=np.uint8)
            staged = 0

            def flush_staging() -> None:
                nonlocal staged
                if staged == 0:
                    return
                if staged < F:
                    staging[staged:] = 0
                pending.append(self.step(staging.copy(), staged))
                self.repeats_done += staged
                staged = 0

            while True:
                with self._status_change:
                    while not self._occupied and not self._acquisition_finished:
                        self._status_change.wait()
                    if not self._occupied and self._acquisition_finished:
                        break
                    buffer = self._occupied.popleft()
                    self._status_change.notify_all()

                remaining = self.params.repeats - self.repeats_done - staged
                frames = self.slicer.push(buffer, max_frames=max(0, remaining))
                # Pack frames into full fixed-shape batches; a partial batch
                # stays staged so consecutive small buffers coalesce into one
                # device step instead of one step per buffer.
                pos = 0
                while pos < len(frames):
                    if staged == 0 and len(frames) - pos >= F:
                        # Direct-feed fast path: a full aligned batch goes to
                        # the device step as a zero-copy VIEW of the buffer —
                        # JAX copies numpy inputs at dispatch time, so the
                        # view need not outlive this call. Skips two host
                        # memcpy passes (staging fill + staging.copy()).
                        pending.append(self.step(frames[pos:pos + F], F))
                        self.repeats_done += F
                        pos += F
                        drain(self.max_in_flight)
                        continue
                    take = min(F - staged, len(frames) - pos)
                    staging[staged:staged + take] = frames[pos:pos + take]
                    staged += take
                    pos += take
                    if staged == F:
                        flush_staging()
                    drain(self.max_in_flight)

            flush_staging()
            drain(0)
        except BaseException as e:  # surfaced to the producer
            with self._status_change:
                self._consumer_error = e
                self._status_change.notify_all()

    # --- diagnostics ---

    def print_queue_histogram(self, stderr=None) -> None:
        print_queue_histogram(self.queue_histogram, stderr)
