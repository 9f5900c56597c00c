"""The port's own copy of ``repro.core.noise``.

Counter-based measurement-noise streams — batched Philox + CRN sharing.

The simulator's jitter used to come from one sequential RNG: every draw
depended on global draw history, so a batched engine had to replay the
exact flat draw order of the scalar path, and two structurally identical
groups could never see the same noise (their draws interleaved).  This
module replaces that history-dependent stream with a *counter-based*
scheme built on NumPy's Philox bit generator:

  * Every noisy ProfileTime submission (one candidate measurement of one
    overlap group) is issued a **ticket** ``(stream key, submission
    index)``.
  * The jitter multipliers for a ticket are a **pure function of the
    ticket**: submission ``i`` owns the fixed counter block
    ``[i * WORDS_PER_SUBMISSION, (i + 1) * WORDS_PER_SUBMISSION)`` of the
    keyed Philox stream; its uniforms are turned into standard normals
    with the Box-Muller transform (fixed consumption: pair ``p`` of
    normals reads uniform words ``2p`` and ``2p + 1``) and exponentiated
    into lognormal(0, sigma) multipliers.

Because tickets are position-keyed rather than history-keyed, a batch of
submissions with contiguous indices is drawn in ONE vectorized
``Generator.random`` call (one ``advance`` to the first block, one read),
and the scalar reference path re-derives bit-identical values by reading
its single block through the same helpers — no draw-order bookkeeping.
NumPy's elementwise float64 ufuncs produce identical bits for identical
inputs regardless of array shape, so batched and per-submission
evaluation agree exactly (asserted in tests/test_noise.py).

Two ticket-issue policies (``Simulator(noise_mode=...)``):

``"default"``
    One stream key per (seed); indices are the global flat submission
    order — request order, candidates within a request in list order.
    Every submission is an independent draw, so structurally identical
    groups legitimately diverge under jitter and trajectory sharing
    stays unsound (matching real per-layer measurement noise).

``"crn"``
    Common random numbers: the stream key is derived from ``(seed,
    structural group fingerprint)`` and the index is the submitting
    group's OWN trajectory position (its running count of noisy
    submissions).  Structurally identical groups therefore see identical
    jitter at identical trajectory positions, which makes their search
    trajectories — and ``scheduler.run_shared`` trajectory sharing —
    provably identical, independent of how group submissions interleave.
    CRN is the standard variance-reduction device for *comparing*
    configurations under noise; it is sound for tuning (the search only
    compares measurements of the same group) but deliberately correlates
    noise across identical layers, so do not use it to study per-layer
    noise statistics.

Keys are 128-bit BLAKE2b digests of ``repr((seed, tag))`` — deterministic
across processes and platforms, unlike ``hash()``.
"""
from __future__ import annotations

import hashlib
import math
import weakref
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: uniform float64 words reserved per submission ticket.  Must be a
#: multiple of 4 (Philox emits 4 words per counter increment); supports up
#: to ``WORDS_PER_SUBMISSION`` jitters per submission (Box-Muller pairs).
WORDS_PER_SUBMISSION = 64

NOISE_MODES = ("default", "crn")

_TWO_PI = 2.0 * math.pi

#: ticket spec issued by :meth:`NoiseModel.reserve` plus the jitter count:
#: ``(stream key, first submission index, submissions, jitters each)``.
RunSpec = Tuple[int, int, int, int]


def stream_key(seed: int, tag: object) -> int:
    """128-bit Philox key for ``(seed, tag)`` — a stable BLAKE2b digest of
    the repr, so streams are reproducible across processes (``hash()`` is
    salted) and distinct tags never collide in practice."""
    digest = hashlib.blake2b(repr((seed, tag)).encode(), digest_size=16).digest()
    return int.from_bytes(digest, "little")


def uniform_rows(key: int, first: int, count: int) -> np.ndarray:
    """The reserved uniform words of ``count`` contiguous submissions
    starting at index ``first``, shape ``(count, WORDS_PER_SUBMISSION)``.
    One ``advance`` + one ``random`` call; row ``i`` is bit-identical to
    ``uniform_rows(key, first + i, 1)[0]`` because Philox is counter-based
    and ``Generator.random`` consumes exactly one word per float64.

    This is the REFERENCE implementation of the stream; the hot path is
    :meth:`NoiseModel.uniforms`, which keeps one bit generator per key and
    re-seats its counter instead of paying ``Philox(key=...)`` key
    expansion (~tens of microseconds) on every draw.  The two are asserted
    bit-equal in tests/test_noise.py.
    """
    bg = np.random.Philox(key=key)
    bg.advance(first * (WORDS_PER_SUBMISSION // 4))  # advance() steps 4-word blocks
    u = np.random.Generator(bg).random(count * WORDS_PER_SUBMISSION)
    return u.reshape(count, WORDS_PER_SUBMISSION)


def lognormal_rows(u: np.ndarray, sigma: float, width: int) -> np.ndarray:
    """First ``width`` lognormal(0, sigma) jitters of each submission row.

    Box-Muller with fixed consumption: pair ``p`` reads words ``2p`` and
    ``2p + 1`` of the row, so jitter ``j`` depends only on its own pair —
    the value is independent of ``width`` and of the other rows, which is
    what lets heterogeneous batches share one uniform block.
    """
    if width > WORDS_PER_SUBMISSION:
        raise ValueError(
            f"group has {width} ops; raise noise.WORDS_PER_SUBMISSION "
            f"(currently {WORDS_PER_SUBMISSION}) to reserve more draws"
        )
    if width == 0:
        return np.empty((u.shape[0], 0))
    pairs = (width + 1) // 2
    u1 = 1.0 - u[:, 0 : 2 * pairs : 2]  # (0, 1] — log() stays finite
    u2 = u[:, 1 : 2 * pairs : 2]
    r = np.sqrt(-2.0 * np.log(u1))
    ang = _TWO_PI * u2
    z = np.empty((u.shape[0], 2 * pairs))
    z[:, 0::2] = r * np.cos(ang)
    z[:, 1::2] = r * np.sin(ang)
    return np.exp(sigma * z[:, :width])


class NoiseModel:
    """Per-simulator ticket issue + vectorized jitter draws.

    The model owns the mutable stream state: the global submission counter
    (default mode) or the per-fingerprint keys and per-group trajectory
    positions (CRN mode).  Jitter *values* never depend on this state
    beyond the issued ticket, so any consumer holding a ticket can
    re-derive its draws.
    """

    _TRAJ_MEMO_MAX = 65536  # CRN per-group position memo bound (see reserve)

    def __init__(self, seed: int, sigma: float, mode: str = "default"):
        if mode not in NOISE_MODES:
            raise ValueError(f"noise_mode must be one of {NOISE_MODES}, got {mode!r}")
        self.seed = seed
        self.sigma = float(sigma)
        self.mode = mode
        self._default_key = stream_key(seed, "default")
        self._next = 0  # default mode: global flat submission index
        self._fp_keys: Dict[Tuple, int] = {}  # crn: fingerprint -> stream key
        self._traj: Dict[int, List] = {}  # crn: id(group) -> [group, key, next]
        self._bgs: Dict[int, Tuple] = {}  # key -> (bitgen, Generator, state)

    # -- stream reads ----------------------------------------------------
    def uniforms(self, key: int, first: int, count: int) -> np.ndarray:
        """Hot-path twin of :func:`uniform_rows` (bit-identical): the bit
        generator for ``key`` is built once and its counter re-seated per
        read, skipping per-call Philox key expansion."""
        ent = self._bgs.get(key)
        if ent is None:
            bg = np.random.Philox(key=key)
            ent = (bg, np.random.Generator(bg), bg.state)
            self._bgs[key] = ent
        bg, gen, state = ent
        # block counter = submissions * blocks-per-submission; buffer_pos=4
        # marks the 4-word output buffer empty so the read starts at the
        # counter (the template state is pristine: pos 4, counter zeroed)
        state["state"]["counter"][0] = first * (WORDS_PER_SUBMISSION // 4)
        bg.state = state
        u = gen.random(count * WORDS_PER_SUBMISSION)
        return u.reshape(count, WORDS_PER_SUBMISSION)

    # -- ticket issue ----------------------------------------------------
    def reserve(self, g, n: int) -> Tuple[int, int]:
        """Issue ``n`` submission tickets for group ``g`` in flat
        submission order; returns ``(stream key, first index)`` — the
        tickets are the contiguous index range ``[first, first + n)``.

        CRN positions are tracked per group *instance* (weakly — a
        collected group's trajectory can never resume, so its entry is
        purged): a live group object re-entering the tuner continues its
        trajectory.  Trajectory position is semantic state, not a cache —
        dropping a LIVE group's entry would silently replay its draws and
        break the serial == interleaved == shared equality — so when the
        memo is full of live groups this raises instead of evicting; use a
        fresh ``Simulator`` per tuning session.
        """
        if self.mode == "default":
            first = self._next
            self._next += n
            return self._default_key, first
        ent = self._traj.get(id(g))
        if ent is None or ent[0]() is not g:  # dead/reused id -> fresh entry
            from repro_torch.core.profiling import group_fingerprint

            fp = group_fingerprint(g)
            key = self._fp_keys.get(fp)
            if key is None:
                key = stream_key(self.seed, ("crn", fp))
                self._fp_keys[fp] = key
            if len(self._traj) >= self._TRAJ_MEMO_MAX:
                self._traj = {i: e for i, e in self._traj.items() if e[0]() is not None}
                if len(self._traj) >= self._TRAJ_MEMO_MAX:
                    raise RuntimeError(
                        f"more than {self._TRAJ_MEMO_MAX} live CRN group "
                        f"trajectories in one Simulator; tune with a fresh "
                        f"Simulator per session"
                    )
            ent = [weakref.ref(g), key, 0]
            self._traj[id(g)] = ent
        first = ent[2]
        ent[2] += n
        return ent[1], first

    # -- draws -----------------------------------------------------------
    def draw(self, g, n: int, width: int) -> np.ndarray:
        """Reserve ``n`` tickets for ``g`` and return their jitters,
        shape ``(n, width)`` (row layout: M comp jitters then N comm)."""
        key, first = self.reserve(g, n)
        return lognormal_rows(self.uniforms(key, first, n), self.sigma, width)

    def group_jitters(self, g, m: int, n: int) -> Tuple[List[float], List[float]]:
        """One submission's jitters for the scalar reference path:
        ``(comp multipliers, comm multipliers)`` as plain floats."""
        row = self.draw(g, 1, m + n)[0].tolist()
        return row[:m], row[m:]

    def draw_reserved(self, specs: Sequence[RunSpec]) -> List[np.ndarray]:
        """Jitter matrices for already-reserved ticket runs, one
        ``(count, width)`` array per spec.  Contiguous same-key spans
        (the whole batch, in default mode) share ONE uniform draw."""
        out: List[np.ndarray] = []
        i = 0
        while i < len(specs):
            key, first, total, _ = specs[i]
            j = i + 1
            while (
                j < len(specs)
                and specs[j][0] == key
                and specs[j][1] == first + total
            ):
                total += specs[j][2]
                j += 1
            u = self.uniforms(key, first, total)
            off = 0
            for k in range(i, j):
                _, _, cnt, width = specs[k]
                out.append(lognormal_rows(u[off : off + cnt], self.sigma, width))
                off += cnt
            i = j
        return out
