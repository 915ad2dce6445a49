"""The subscription match on the device, as torch ops.

The port of ``binquant_tpu/fanout/kernel.py``. One match joins a tick's
fired slots against the compiled subscription planes: gather the fired
rows' symbol and strategy words, OR in the wildcard masks, AND with the
regime row and the per-user strength verdict packed on the fly, and return
``(K, U32)`` packed recipient words. Churn patches the device copy one word
per dirty cell (:func:`apply_subscription_deltas`).

Bit layout: slot ``u`` lives at word ``u >> 5``, bit ``u & 31``
(LSB-first, ``np.packbits(bitorder="little")``); :func:`unpack_slots` and
:func:`popcount_words` are the host-side decoders.

uint32 on the device: torch shifts and scatters no ``uint32`` tensor, so
the device planes hold the same bits as ``int32`` (the host arrays viewed
as ``np.int32`` on the way in, the words viewed back as ``np.uint32`` on
the way out). ``&``, ``|``, ``<<`` and the scatters are then bit for bit
the reference's.

The strength plane is built without a ``(K, U)`` integer intermediate:
the reference's compiler fuses ``|score| >= floor`` into the pack, eager
torch does not, so :func:`_strength_words` ORs 32 shifted ``(K, U32)``
bit planes, one per bit position, read from the floors transposed to
``(32, U32)``. A NaN score matches no floor; an unoccupied slot's floor is
``+inf`` and its plane bits are zero.
"""

from __future__ import annotations

import numpy as np
import torch

_BITS = 32


def pack_words_np(bits: np.ndarray) -> np.ndarray:
    """Host reference pack: (..., U) bool → (..., U//32) uint32,
    LSB-first. U must be a multiple of 32 (registry capacity always is)."""
    bits = np.asarray(bits, bool)
    assert bits.shape[-1] % _BITS == 0, bits.shape
    packed = np.packbits(bits, axis=-1, bitorder="little")
    return packed.view(np.uint32) if packed.flags["C_CONTIGUOUS"] else (
        np.ascontiguousarray(packed).view(np.uint32)
    )


def unpack_words_np(words: np.ndarray) -> np.ndarray:
    """(..., U32) uint32 → (..., U) bool, the inverse of the device pack."""
    words = np.ascontiguousarray(np.asarray(words, np.uint32))
    return np.unpackbits(
        words.view(np.uint8), axis=-1, bitorder="little"
    ).astype(bool)


def unpack_slots(words: np.ndarray) -> np.ndarray:
    """One packed row → the sorted slot indices whose bit is set."""
    return np.flatnonzero(unpack_words_np(np.atleast_1d(words).ravel()))


_POP8 = np.array(
    [bin(i).count("1") for i in range(256)], np.uint8
)  # byte-popcount lookup


def popcount_words(words: np.ndarray) -> int:
    """Total set bits in a packed array (recipient count) without
    materializing the unpacked bool plane."""
    w = np.ascontiguousarray(np.asarray(words, np.uint32))
    return int(_POP8[w.view(np.uint8)].sum(dtype=np.int64))


def to_device_words(a: np.ndarray, device) -> torch.Tensor:
    """A host uint32 array as the device's int32 tensor of the same bits
    (a copy on the CPU too: the device planes never alias the registry's)."""
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint32).view(np.int32)
    ).to(device, copy=True)


def to_host_words(t: torch.Tensor) -> np.ndarray:
    """A device int32 word tensor as host uint32 (the same bits)."""
    return t.cpu().numpy().view(np.uint32)


def _pack_u32(bits: torch.Tensor) -> torch.Tensor:
    """(K, U) bool → (K, U32) int32 words, LSB-first: bit ``b`` of word
    ``w`` is ``bits[:, 32 w + b]``."""
    k, u = bits.shape
    grouped = bits.reshape(k, u // _BITS, _BITS)
    out = torch.zeros((k, u // _BITS), dtype=torch.int32, device=bits.device)
    for b in range(_BITS):
        out |= grouped[:, :, b].to(torch.int32) << b
    return out


def pack_bits_device(bits: np.ndarray, device) -> np.ndarray:
    """Device twin of :func:`pack_words_np` on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(bits, bool)).to(device)
    return to_host_words(_pack_u32(t))


def _strength_words(scores: torch.Tensor, floors: torch.Tensor) -> torch.Tensor:
    """``|scores[k]| >= floors[u]`` packed to (K, U32) int32 words, one
    (K, U32) compare per bit position."""
    mag = scores.abs()[:, None]
    by_bit = floors.reshape(-1, _BITS).t()  # (32, U32): floors of bit b
    out = torch.zeros(
        (scores.shape[0], by_bit.shape[1]), dtype=torch.int32, device=scores.device
    )
    for b in range(_BITS):
        out |= (mag >= by_bit[b][None, :]).to(torch.int32) << b
    return out


def match_planes(
    sym_plane: torch.Tensor,      # (S+1, U32) int32
    strat_plane: torch.Tensor,    # (N, U32) int32
    regime_plane: torch.Tensor,   # (R+1, U32) int32
    any_masks: torch.Tensor,      # (3, U32) int32: [sym_any, strat_any, regime_any]
    floors: torch.Tensor,         # (U,) f32 (+inf on unoccupied slots)
    rows: torch.Tensor,           # (K,) int64 fired symbol rows (0 on padding)
    strats: torch.Tensor,         # (K,) int64 fired strategy indices (0 on padding)
    scores: torch.Tensor,         # (K,) f32 fired scores
    valid: torch.Tensor,          # (K,) bool — padding slots are False
    regime_row: int,              # index into regime_plane (R = invalid ctx)
) -> torch.Tensor:
    """The reference's ``_match_impl``: (K, U32) int32 recipient words."""
    sym_m = sym_plane[rows] | any_masks[0][None, :]
    strat_m = strat_plane[strats] | any_masks[1][None, :]
    reg_m = (regime_plane[regime_row] | any_masks[2])[None, :]
    out = sym_m & strat_m & reg_m & _strength_words(scores, floors)
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def apply_subscription_deltas(
    sym_plane, strat_plane, regime_plane, any_masks, floors,
    sym_r, sym_w, sym_v,        # (B,) int64/int64/int32 sym_plane cells
    strat_r, strat_w, strat_v,  # (B,) strat_plane cells
    reg_r, reg_w, reg_v,        # (B,) regime_plane cells
    any_r, any_w, any_v,        # (B,) any_masks cells
    floor_idx,                  # (F,) int64 dirty floor words
    floor_vals,                 # (F, 32) f32
):
    """The churn resync: write ONE WORD per dirty (plane, row, word) cell
    into the device planes, in place — O(cells touched), independent of
    the population and the symbol count. Every group pads to a shared
    bucket; pad entries point at cell (0, 0) carrying the host's current
    value there, so duplicates always write identical values and the
    scatter order is immaterial. Returns the five planes."""
    sym_plane[sym_r, sym_w] = sym_v
    strat_plane[strat_r, strat_w] = strat_v
    regime_plane[reg_r, reg_w] = reg_v
    any_masks[any_r, any_w] = any_v
    floors.view(-1, _BITS)[floor_idx] = floor_vals
    return sym_plane, strat_plane, regime_plane, any_masks, floors


def bucket(n: int, floor: int = 4) -> int:
    """Next power-of-two padding bucket (the fired and dirty-cell counts
    pad to it, as the reference's compiled shapes do)."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


class DevicePlanes:
    """Device-resident copy of a :class:`SubscriptionRegistry`'s planes
    on ``device`` with the lazy sync policy: a capacity change (or first
    use) pushes everything (``kind="full"``), churn patches only the dirty
    (plane, row, word) cells through :func:`apply_subscription_deltas`
    (``kind="incremental"``). :meth:`sync` returns the kind performed
    (None = already current); ``last_delta_words`` holds the patched word
    count of the most recent incremental sync."""

    def __init__(self, registry, *, device) -> None:
        self.registry = registry
        self.device = torch.device(device)
        self._arrays: tuple[torch.Tensor, ...] | None = None
        self._synced_version: int | None = None
        self._synced_generation: int | None = None
        self.last_delta_words = 0

    def host_planes(self) -> tuple[np.ndarray, ...]:
        """The device planes copied back to the host in the registry's
        dtypes (uint32 words, f32 floors)."""
        assert self._arrays is not None, "sync() first"
        *words, floors = self._arrays
        return (*(to_host_words(w) for w in words), floors.cpu().numpy())

    def sync(self) -> str | None:
        reg = self.registry
        if (
            self._arrays is not None
            and self._synced_version == reg.version
        ):
            return None
        full = (
            self._arrays is None
            or self._synced_generation != reg.capacity_generation
            or not (reg.dirty_cells or reg.dirty_floor_words)
        )
        dev = self.device
        if full:
            self._arrays = (
                *(
                    to_device_words(a, dev)
                    for a in (
                        reg.sym_plane, reg.strat_plane, reg.regime_plane,
                        reg.any_masks,
                    )
                ),
                torch.from_numpy(np.ascontiguousarray(reg.floors, np.float32)).to(
                    dev, copy=True
                ),
            )
            kind = "full"
        else:
            # group the dirty cells by plane; all four groups share ONE
            # power-of-two bucket, as the reference's do
            per: list[list[tuple[int, int]]] = [[], [], [], []]
            for pid, r, w in reg.dirty_cells:
                per[pid].append((r, w))
            planes = (
                reg.sym_plane, reg.strat_plane, reg.regime_plane,
                reg.any_masks,
            )
            b = bucket(max(max(len(g) for g in per), 1))
            args: list[torch.Tensor] = []
            for pid in range(4):
                rows = np.zeros(b, np.int64)
                words = np.zeros(b, np.int64)
                g = per[pid]
                if g:
                    cells = np.asarray(g, np.int64)
                    rows[: len(g)] = cells[:, 0]
                    words[: len(g)] = cells[:, 1]
                # values gathered from the HOST planes (the post-churn
                # truth): pad entries read cell (0, 0), so a pad write
                # is always a no-op rewrite of the current value
                vals = planes[pid][rows, words]
                args += [
                    torch.from_numpy(rows).to(dev),
                    torch.from_numpy(words).to(dev),
                    to_device_words(vals, dev),
                ]
            fw = sorted(reg.dirty_floor_words)
            fb = bucket(max(len(fw), 1))
            fidx = np.zeros(fb, np.int64)
            fidx[: len(fw)] = fw
            fvals = reg.floors.reshape(-1, _BITS)[fidx]
            self.last_delta_words = len(reg.dirty_cells) + len(fw)
            self._arrays = apply_subscription_deltas(
                *self._arrays,
                *args,
                torch.from_numpy(fidx).to(dev),
                torch.from_numpy(np.ascontiguousarray(fvals, np.float32)).to(dev),
            )
            kind = "incremental"
        reg.dirty_cells.clear()
        reg.dirty_floor_words.clear()
        self._synced_version = reg.version
        self._synced_generation = reg.capacity_generation
        return kind

    def match(
        self,
        rows: np.ndarray,
        strats: np.ndarray,
        scores: np.ndarray,
        regime_row: int,
    ) -> np.ndarray:
        """Join ``k`` fired slots against the planes on the device;
        returns ``(k, U32)`` packed recipient words (host uint32). The
        fired axis pads to a power-of-two bucket, as the reference's."""
        assert self._arrays is not None, "sync() before match()"
        k = len(rows)
        kb = bucket(k)
        rows_p = np.zeros(kb, np.int64)
        strats_p = np.zeros(kb, np.int64)
        scores_p = np.zeros(kb, np.float32)
        valid = np.zeros(kb, bool)
        rows_p[:k] = rows
        strats_p[:k] = strats
        scores_p[:k] = scores
        valid[:k] = True
        dev = self.device
        out = match_planes(
            *self._arrays,
            torch.from_numpy(rows_p).to(dev),
            torch.from_numpy(strats_p).to(dev),
            torch.from_numpy(scores_p).to(dev),
            torch.from_numpy(valid).to(dev),
            int(regime_row),
        )
        return to_host_words(out[:k])
