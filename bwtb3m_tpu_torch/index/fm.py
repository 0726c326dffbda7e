"""FM index: backward search, LF walks, locate and extract, on the card.

Port of ``bwtb3m_tpu/index/fm.py``: a rank structure, the C array and
the sampled SA / ISA, the roles of libmaus2's ``lf::*LF`` classes and
``fm::SampledSA`` / ``SampledISA`` as upstream src/probeScanDna.cpp:100-107
(``LF.step``) and src/bwtdecodeblock.cpp (range decode from the sampled
ISA by LF) use them.

The reference answers every query on the host over a Huffman wavelet
tree, an RL wavelet tree or a ``DNARank``: ``locate_batch`` steps all
lanes by host ``inverse_select`` until each rank is sampled, and
``extract`` walks one lane from the next ISA sample, up to the ISA rate
of dependent host steps (262,144 at the genome builds' rate).  Here one
query engine serves every ``structure``: the rank rows of the same BWT on
``device`` (sector, bit-plane or byte rows, wide rows from 2^32 symbols,
wavelet rows past 256 symbols), taken from ``BwtResult.load_focc`` /
``load_wavelet`` (their memo and the build's hand-off) or, for an index
constructed from a ranker, built from its symbols.  ``rank``, ``step``,
``extended_lf``, ``backward_search`` and ``count`` are batched torch
(``ops/lf.py``); ``locate_batch`` is one launch of the LF-walk kernel's
locate visit and ``extract`` one of its decode visit (``ops/lf_walk.py``;
their plain versions on the CPU), on lanes that start at the sampled ISA
and, where the index has one, at every sampled SA position in the range
(``decode_lanes_sa``).  Symbols in and
out are the ``.bwt`` file's (``load_bwt()``'s): the rows hold dense ids
and map back through their symbol map.  Answers are numpy arrays, as the
reference's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import lf as lfops
from ..ops import lf_walk
from ..ops import wavelet_rows as wr
from ..ops.focc import lf_step as lf_step_narrow
from ..ops.wideocc import WideOcc, lf_step_w
from ..util.devices import resolve_device
from .dnarank import DNARank
from .sampled import SampledISA, SampledSA

STRUCTURES = ("hwt", "rlhwt", "dnarank")


def rows_from_symbols(bwt: np.ndarray, device):
    """(rank rows, symbol map or None) of a BWT of any integer symbols on
    ``device``: the symbols densified as ``BwtResult.load_focc`` does
    (``symmap[dense id]`` is the symbol; None where they are dense
    already), fused rows up to 256 symbols (wide from 2^32 symbols or
    under ``BWTB3M_FORCE_WIDE``), wavelet rows past."""
    from ..engine.result import wide_rows
    from ..ops.focc_build import build_focc_host

    bwt = np.asarray(bwt, dtype=np.int64)
    present, dense = np.unique(bwt, return_inverse=True)
    symmap = None
    if len(present) and (present[-1] >= len(present)):
        symmap = present.astype(np.int64)
    sigma = max(1, len(present))
    if sigma <= 256:
        rows = build_focc_host(dense.astype(np.uint8), sigma, device,
                               wide=wide_rows(len(bwt)))
    else:
        rows = wr.build_wavelet_host(dense.astype(np.int32), sigma, device)
    return rows, symmap


def decode_lanes(isa: SampledISA, n: int, start: int, length: int):
    """(ranks, positions, segment lengths) of the decode walk of text
    [start, start + length) (circular, length <= n): a lane at each
    sampled ISA position in (start, A], A the first sample at or after
    the range's end (circularly, in unwrapped coordinates), each walking
    back to the previous lane's position or to start."""
    rate = int(isa.rate)
    end = start + length
    lap = (end // n) * n
    k = -(-(end - lap) // rate)
    anchor = lap + k * rate if k * rate < n else lap + n
    x = np.arange(len(isa.values), dtype=np.int64) * rate
    x = np.concatenate([x, x + n, x + 2 * n])
    x = x[(x > start) & (x <= anchor)]
    seg = np.diff(np.concatenate([[start], x]))
    p0 = x % n
    return isa.values[p0 // rate], p0, seg


def decode_lanes_sa(isa: SampledISA, sa_values: torch.Tensor, sa_rate: int,
                    n: int, start: int, length: int):
    """(ranks, positions, segment lengths) as int64 tensors on
    ``sa_values``' device: the decode walk of text [start, start +
    length) as ``decode_lanes`` plans it, with a lane more at every .sa
    sample whose position lies in (start, A] (unwrapped, A the last lane
    of ``decode_lanes``; a position in it twice where the range takes n
    symbols): sample i is rank i * sa_rate at position sa_values[i].  A
    position held by an ISA and an SA sample keeps one lane; each lane
    walks back to the previous lane's position or to start.  Built with
    torch on the samples' device, one masked compaction of the samples
    and one sort of the survivors: at rate 32 a range of L symbols gets
    about L / 32 lanes of 32 steps on average."""
    r_isa, _p, seg_isa = decode_lanes(isa, n, start, length)
    dev = sa_values.device
    x = start + np.cumsum(seg_isa)               # unwrapped positions
    span = int(x[-1]) - start                    # A - start, below 2n
    # sample i lies at unwrapped start + 1 + d[i] and, a lap on, + n
    d = (sa_values - (start + 1)).remainder_(n)
    xs = [torch.from_numpy(x).to(dev)]
    rs = [torch.from_numpy(r_isa).to(dev)]
    for lap in (0, n):
        if span > lap:
            i = torch.nonzero(d < span - lap).squeeze(1)
            xs.append(d[i] + (start + 1 + lap))
            rs.append(i * sa_rate)
    del d
    x, order = torch.sort(torch.cat(xs), stable=True)
    r = torch.cat(rs)[order]
    keep = torch.ones_like(x, dtype=torch.bool)
    keep[1:] = x[1:] != x[:-1]
    x, r = x[keep], r[keep]
    return r, x % n, torch.diff(x, prepend=x.new_tensor([start]))


class FMIndex:
    def __init__(self, ranker, sigma: int, n: int,
                 sampled_sa: Optional[SampledSA] = None,
                 sampled_isa: Optional[SampledISA] = None,
                 device="cuda", *, rows=None, symmap=None,
                 structure: Optional[str] = None):
        """``ranker``: a ``HuffmanWaveletTree``, ``RLHuffmanWaveletTree``
        or ``DNARank`` whose symbols the rank rows are built from, or None
        with ``rows`` / ``symmap`` given (``from_bwt_result``).
        ``structure`` names the reference's structure whose answers' shapes
        the queries keep (a ``DNARank`` ranks a scalar position as a
        scalar)."""
        self.device = resolve_device(device)
        self.ranker = ranker
        self.structure = structure or (
            "dnarank" if isinstance(ranker, DNARank) else "hwt")
        self.sigma = sigma
        self.n = n
        self.sa = sampled_sa
        self.isa = sampled_isa
        if rows is None:
            if isinstance(ranker, DNARank):
                bwt = ranker.symbol(np.arange(n, dtype=np.int64))
            else:
                bwt = ranker.decode_all()
            rows, symmap = rows_from_symbols(bwt, self.device)
        self.rows = rows
        self.symmap = None if symmap is None else np.asarray(symmap,
                                                            np.int64)
        self._C_dense = lfops.c_values(rows)
        dense_sigma = len(self._C_dense) - 1
        syms = (np.arange(dense_sigma, dtype=np.int64) if self.symmap is None
                else self.symmap)
        # C over the full symbol domain
        counts = np.zeros(max(sigma, int(syms.max(initial=-1)) + 1),
                          dtype=np.int64)
        counts[syms] = (self._C_dense[1:] - self._C_dense[:-1]).cpu().numpy()
        self.C = np.concatenate([[0], np.cumsum(counts)])
        # file symbol -> dense id, -1 where absent
        self._dense = torch.full((len(counts),), -1, dtype=torch.int64,
                                 device=self.device)
        self._dense[torch.from_numpy(syms).to(self.device)] = torch.arange(
            dense_sigma, device=self.device)
        self._symbols = torch.from_numpy(syms).to(self.device)
        self._sa_dev = None
        self.last_locate = None

    # ---- construction ---------------------------------------------------
    @classmethod
    def from_bwt_result(cls, result, structure: str = "hwt",
                        device="cuda") -> "FMIndex":
        """From a BwtResult's files; ``structure`` (hwt | rlhwt | dnarank)
        names the reference's rank structure, whose refusals it keeps
        (``DNARank`` takes symbols 0..3).  The queries run over the rank
        rows of ``result.load_focc`` (``load_wavelet`` past 256 symbols);
        no ``.hwt`` is built."""
        device = resolve_device(device)
        if result.sigma > 256:
            rows, symmap = result.load_wavelet(device, dense=True)
        else:
            rows, symmap = result.load_focc(device, dense=True)
        if structure == "dnarank":
            top = (int(symmap.max()) if symmap is not None
                   else len(lfops.c_values(rows)) - 2)
            if top > 3:
                raise ValueError("DNARank requires a 4-symbol alphabet BWT")
        ssa = (SampledSA.load(result.sa_path, result.n) if result.sa_path
               else None)
        sisa = (SampledISA.load(result.isa_path, result.n)
                if result.isa_path else None)
        return cls(None, result.sigma, result.n, ssa, sisa, device,
                   rows=rows, symmap=symmap, structure=structure)

    # ---- primitives -----------------------------------------------------
    def _lanes(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.int64).reshape(-1)
        return torch.from_numpy(np.atleast_1d(np.asarray(
            x, dtype=np.int64)).copy()).to(self.device)

    def dense_ids(self, c) -> torch.Tensor:
        """The rows' dense ids of file symbols ``c`` (-1 where absent)."""
        c = self._lanes(c)
        inside = (c >= 0) & (c < len(self._dense))
        return torch.where(inside, self._dense[c.clamp(0, len(self._dense)
                                                         - 1)], -1)

    def _rank_dense(self, d: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        return torch.where(d >= 0, lfops.rank(self.rows, d.clamp(min=0), i),
                           0)

    def _shaped(self, x: np.ndarray, like):
        """A DNARank answers a scalar position with a scalar, the
        wavelet trees with an array of one."""
        if self.structure == "dnarank" and np.ndim(like) == 0:
            return x[0]
        return x

    def rank(self, c: int, i) -> np.ndarray:
        """Occurrences of symbol c in bwt[0 : i) for a batch of i."""
        t = self._lanes(i)
        d = self.dense_ids([int(c)]).expand(len(t))
        return self._shaped(self._rank_dense(d, t).cpu().numpy(), i)

    def step(self, c: int, lo, hi) -> Tuple[np.ndarray, np.ndarray]:
        """Backward-search step (reference ``LF.step(sym, lo, hi)``)."""
        lo_t, hi_t = self._lanes(lo), self._lanes(hi)
        d = self.dense_ids([int(c)])
        r = self._rank_dense(d.expand(len(lo_t) + len(hi_t)),
                             torch.cat([lo_t, hi_t])).cpu().numpy()
        return (self.C[c] + self._shaped(r[:len(lo_t)], lo),
                self.C[c] + self._shaped(r[len(lo_t):], hi))

    def extended_lf(self, r):
        """(sym, LF(r)), one backwards step of the decode walk (batched)."""
        r = self._lanes(r)
        if isinstance(self.rows, wr.WaveletRows):
            sym, r2 = wr.lf_step(self.rows, r)
        elif isinstance(self.rows, WideOcc):
            sym, r2 = lf_step_w(self.rows, r)
        else:
            sym, r2 = lf_step_narrow(self.rows, r)
        return self._symbols[sym].cpu().numpy(), r2.cpu().numpy()

    # ---- queries --------------------------------------------------------
    def backward_search(self, pattern) -> Tuple[int, int]:
        """Interval of rotations prefixed by `pattern` (processed
        right-to-left). Returns half-open (lo, hi)."""
        lo, hi = 0, self.n
        for c in reversed(np.asarray(pattern, dtype=np.int64)):
            lo, hi = self.step(int(c), [lo], [hi])
            lo, hi = int(lo[0]), int(hi[0])
            if hi <= lo:
                return lo, lo
        return lo, hi

    def count(self, pattern) -> int:
        lo, hi = self.backward_search(pattern)
        return hi - lo

    def locate(self, r: int) -> int:
        """Text position of rank r via LF walk to the nearest SA sample."""
        return int(self.locate_batch([int(r)])[0])

    def locate_batch(self, ranks) -> np.ndarray:
        """Text positions of a batch of ranks: one lane a rank walks LF to
        the first rank that is a multiple of the SA's rate (the LF-walk
        kernel's locate visit), then SA = (sample + steps) mod n.  Keeps
        the walk's lanes, steps and longest walk in ``last_locate``."""
        if self.sa is None:
            raise ValueError("no sampled SA attached")
        r = self._lanes(ranks)
        if len(r) == 0:
            return np.zeros(0, dtype=np.int64)
        rate = int(self.sa.rate)
        r_end, steps = lf_walk.locate_walk(self.rows, r, rate)
        longest = int(steps.max())
        if int(steps.min()) < 0:
            raise AssertionError("a locate walk met no sampled rank within "
                                 "n steps: the LF map is not one cycle")
        pos = (self._sa_values()[r_end // rate] + steps) % self.n
        self.last_locate = {"lanes": len(r), "steps": int(steps.sum()),
                            "longest": longest}
        return pos.cpu().numpy()

    def locate_range(self, lo: int, hi: int) -> np.ndarray:
        return np.sort(self.locate_batch(np.arange(lo, hi)))

    def _sa_values(self) -> torch.Tensor:
        """The sampled SA on the index's device, kept after the first
        call (locate and decode share it)."""
        if self._sa_dev is None:
            self._sa_dev = torch.from_numpy(self.sa.values).to(self.device)
        return self._sa_dev

    def decode_plan(self, start: int, length: int):
        """The decode walk's lanes (ranks, positions, segment lengths as
        tensors on the index's device) of text [start, start + length),
        0 <= start < n, 0 < length <= n: ``decode_lanes_sa`` where the
        index holds a sampled SA, else ``decode_lanes``, the same kernel
        on fewer and longer lanes (one per ISA sample)."""
        if self.sa is None:
            return tuple(self._lanes(a) for a in decode_lanes(
                self.isa, self.n, start, length))
        return decode_lanes_sa(self.isa, self._sa_values(),
                               int(self.sa.rate), self.n, start, length)

    def extract(self, start: int, length: int) -> np.ndarray:
        """Decode text[start : start+length] (circular) from the index:
        the bwtdecodeblock role.  Lanes start at the sampled ISA positions
        that the range needs and at every SA sample inside it
        (``decode_plan``) and walk back together, one launch of the
        LF-walk kernel's decode visit."""
        if self.isa is None:
            raise ValueError("no sampled ISA attached")
        length = int(length)
        if length <= 0 or self.n == 0:
            return np.zeros(max(length, 0), dtype=np.int64)
        m = min(length, self.n)
        start = int(start) % self.n
        r0, p0, seg = self.decode_plan(start, m)
        out = lf_walk.decode_walk(self.rows, r0, p0, seg, start, m)
        dense = out.cpu().numpy()
        if dense.dtype == np.int16:
            dense = dense.view(np.uint16)
        syms = (dense.astype(np.int64) if self.symmap is None
                else self.symmap[dense])
        if length > m:                    # the text is circular
            syms = np.resize(syms, length)
        return syms


def fm_from_jax(jax_fm, device="cuda") -> FMIndex:
    """The port's ``FMIndex`` over the same BWT and samples as a reference
    ``FMIndex``: the symbols read back from its ranker (a DNARank's
    ``symbol``, a wavelet tree's ``decode_all``; host numpy, so this
    module needs no JAX import), its sampled SA / ISA arrays, and its C,
    which the port's must equal."""
    ranker = jax_fm.ranker
    if hasattr(ranker, "occ"):            # DNARank
        bwt = ranker.symbol(np.arange(int(jax_fm.n), dtype=np.int64))
    else:
        bwt = ranker.decode_all()
    rows, symmap = rows_from_symbols(bwt, resolve_device(device))

    def samples(s, cls):
        return None if s is None else cls(int(s.rate), np.asarray(s.values),
                                          int(s.n))

    fm = FMIndex(None, int(jax_fm.sigma), int(jax_fm.n),
                 samples(jax_fm.sa, SampledSA), samples(jax_fm.isa,
                                                        SampledISA),
                 device, rows=rows, symmap=symmap,
                 structure="dnarank" if hasattr(ranker, "occ") else "hwt")
    if not np.array_equal(fm.C[:len(jax_fm.C)], np.asarray(jax_fm.C)):
        raise ValueError("the carried index's C differs from the reference's")
    return fm
