"""Host-RAM KV tier + wire framing for cross-replica prefix migration.

Rung two and rung three of the KV tiering ladder (rung one -- the pool's
page dtype, bf16, unscaled fp8 or int8/fp8 with scales -- lives in
models/llama.py and ops/).  A copy of the JAX package's module; the code
is the same, so a blob from either package installs into the other:

  * :class:`HostKVTier` -- a byte-capped LRU of *spilled* prefix-cache
    entries.  When the device pool is pressured the engine demotes the
    prefix cache's LRU victim here (page rows fetched to host numpy)
    instead of dropping it; the next prompt that would have hit the
    victim rehydrates the rows with one in-place write into the pool
    instead of re-prefilling.  Losing an entry (host-cap eviction, the
    supervisor losing the buffer) is always safe: the engine falls back
    to a plain prefix-cache miss.

  * Blob framing -- ``pack_prefix_blob`` / ``unpack_prefix_blob`` frame a
    prefix's page rows for the page-fetch endpoint (monitor/server.py
    ``/api/v1/kv``).  The record format mirrors the WAL
    (resilience/journal.py):

      blob    := magic(4) record*
      record  := type(u8) length(u32 LE) crc(u32 LE) payload
      crc     := crc32(type_byte + payload)

    META (JSON) carries the geometry contract -- model name, layer
    count, fused lane width, block size, kv_quant mode, page dtype, token
    ids -- and ARRAY records carry raw row bytes, one per (layer,
    k/v/scale) leaf in a fixed order.  A receiver whose META doesn't
    match its own geometry refuses the install (``incompatible``) rather
    than installing garbage pages; any CRC/truncation raises
    :class:`BlobError`.

Stdlib + numpy only (the supervisor constructs the tier before any engine
exists and keeps it across rebuilds).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import struct
import threading
import zlib
from typing import Iterable

import numpy as np

from k8s_llm_monitor_tpu_torch.devtools.lockcheck import guarded_by, make_lock
from k8s_llm_monitor_tpu_torch.resilience.tenancy import DEFAULT_TENANT

logger = logging.getLogger("serving.kv_tier")

#: Wire magic for migration blobs ("KV eXchange v1").
MAGIC = b"KVX1"
REC_META = 1
REC_ARRAY = 2

_HEADER = struct.Struct("<BII")  # type, payload length, crc32
# Largest legitimate ARRAY payload: a long prefix's rows for one leaf.
_MAX_PAYLOAD = 1 << 30

#: Blob geometry-contract version; bump on any layout change.
BLOB_VERSION = 1


class BlobError(Exception):
    """Migration blob failed framing/CRC/geometry validation."""


def pack_records(records: Iterable[tuple[int, bytes]]) -> bytes:
    """Frame ``(type, payload)`` records with the WAL header + CRC."""
    out = [MAGIC]
    for rtype, payload in records:
        crc = zlib.crc32(bytes((rtype,)) + payload) & 0xFFFFFFFF
        out.append(_HEADER.pack(rtype, len(payload), crc))
        out.append(payload)
    return b"".join(out)


def unpack_records(blob: bytes) -> list[tuple[int, bytes]]:
    """Parse and CRC-check a framed blob.  Unlike the WAL scanner this
    RAISES on any damage — a torn journal tail is expected after a
    crash, but a torn migration blob means the transfer failed and the
    receiver must fall back to re-prefill, not install half a prefix."""
    if blob[:len(MAGIC)] != MAGIC:
        raise BlobError("bad magic (not a KV migration blob)")
    off = len(MAGIC)
    records: list[tuple[int, bytes]] = []
    while off < len(blob):
        if off + _HEADER.size > len(blob):
            raise BlobError(f"truncated header at byte {off}")
        rtype, length, crc = _HEADER.unpack_from(blob, off)
        body_start = off + _HEADER.size
        if length > _MAX_PAYLOAD or body_start + length > len(blob):
            raise BlobError(f"truncated record at byte {off}")
        body = blob[body_start:body_start + length]
        if zlib.crc32(bytes((rtype,)) + body) & 0xFFFFFFFF != crc:
            raise BlobError(f"CRC mismatch at byte {off}")
        records.append((rtype, body))
        off = body_start + length
    return records


def pack_prefix_blob(meta: dict, arrays: Iterable[np.ndarray]) -> bytes:
    """META + one ARRAY record per page-row leaf, in the engine's fixed
    per-layer order (k, v[, k_scale, v_scale])."""
    meta = dict(meta, version=BLOB_VERSION)
    recs: list[tuple[int, bytes]] = [
        (REC_META, json.dumps(meta, separators=(",", ":")).encode())]
    for arr in arrays:
        recs.append((REC_ARRAY, np.ascontiguousarray(arr).tobytes()))
    return pack_records(recs)


def unpack_prefix_blob(blob: bytes) -> tuple[dict, list[bytes]]:
    """Inverse of :func:`pack_prefix_blob`; returns (meta, raw leaf
    bytes).  Leaf dtype/shape reconstruction is the caller's job — it
    owns the geometry contract the META is validated against."""
    records = unpack_records(blob)
    if not records or records[0][0] != REC_META:
        raise BlobError("first record is not META")
    try:
        meta = json.loads(records[0][1])
    except ValueError as e:
        raise BlobError(f"undecodable META: {e}") from e
    if not isinstance(meta, dict):
        raise BlobError("META is not an object")
    if meta.get("version") != BLOB_VERSION:
        raise BlobError(f"unsupported blob version {meta.get('version')!r}")
    arrays = []
    for rtype, body in records[1:]:
        if rtype != REC_ARRAY:
            raise BlobError(f"unexpected record type {rtype}")
        arrays.append(body)
    return meta, arrays


@dataclasses.dataclass
class SpilledPrefix:
    """One demoted prefix-cache entry: host copies of its page rows.

    ``layers[li]`` is ``(k, v)`` or ``(k, v, k_scale, v_scale)`` —
    numpy arrays of shape ``[n_blocks, block_size, lanes]`` (scales:
    ``[n_blocks, block_size, kv_heads]``), materialized (``np.asarray``)
    at spill time so the entry survives engine teardown/rebuild."""

    n_blocks: int
    layers: list[tuple[np.ndarray, ...]]
    nbytes: int = 0
    #: Namespace owner.  The digest key is already tenant-seeded (the
    #: chain seed is ``tenant_seed(tenant)``), so cross-tenant probes
    #: cannot match; the tag exists for fairness accounting + stats.
    tenant: str = DEFAULT_TENANT

    def __post_init__(self) -> None:
        if not self.nbytes:
            self.nbytes = sum(
                a.nbytes for leaf in self.layers for a in leaf)


@guarded_by("_lock", "spills", "restores", "lost", "_bytes",
            "_tenant_bytes")
class HostKVTier:
    """Byte-capped LRU of :class:`SpilledPrefix` entries, keyed by the
    prefix cache's chain digest (so a restore probe is the same digest
    walk a device-tier lookup already does).  Digests are tenant-seeded
    upstream, so the key space is already namespaced; the tier adds
    per-tenant byte accounting and a max-share cap (``max_tenant_share``
    of ``max_bytes``, enforced only while >= 2 tenants are resident) so
    one tenant cannot monopolize host RAM either.

    Thread-safe: spill/restore run on the engine step thread, but stats
    are scraped from exporter threads and the supervisor constructs/
    keeps the tier across engine rebuilds.
    """

    def __init__(self, max_bytes: int = 256 << 20,
                 max_tenant_share: float = 1.0):
        self.max_bytes = max_bytes
        self.max_tenant_share = float(max_tenant_share)
        self._entries: dict[bytes, SpilledPrefix] = {}
        self.spills = 0
        self.restores = 0
        #: Entries dropped without restore (host-cap eviction / clear).
        self.lost = 0
        self._bytes = 0
        self._tenant_bytes: dict[str, int] = {}
        # Created last so __init__ writes above stay lockcheck-exempt.
        self._lock = make_lock("host_kv_tier")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def _drop_locked(self, key: bytes, *, lost: bool) -> SpilledPrefix:
        entry = self._entries.pop(key)
        self._bytes -= entry.nbytes
        rem = self._tenant_bytes.get(entry.tenant, 0) - entry.nbytes
        if rem > 0:
            self._tenant_bytes[entry.tenant] = rem
        else:
            self._tenant_bytes.pop(entry.tenant, None)
        if lost:
            self.lost += 1
        return entry

    def _tenant_lru_locked(self, tenant: str,
                           skip: bytes | None = None) -> bytes | None:
        for key, entry in self._entries.items():
            if entry.tenant == tenant and key != skip:
                return key
        return None

    def put(self, digest: bytes, entry: SpilledPrefix, *,
            tenant: str = DEFAULT_TENANT) -> bool:
        """Admit a demoted entry under ``tenant``'s namespace; returns
        False when it can never fit (bigger than the whole cap) — the
        caller then just drops it."""
        entry.tenant = tenant
        if entry.nbytes > self.max_bytes:
            return False
        with self._lock:
            if digest in self._entries:
                self._drop_locked(digest, lost=False)
            while self._bytes + entry.nbytes > self.max_bytes:
                self._drop_locked(next(iter(self._entries)), lost=True)
            self._entries[digest] = entry
            self._bytes += entry.nbytes
            self._tenant_bytes[tenant] = (
                self._tenant_bytes.get(tenant, 0) + entry.nbytes)
            self.spills += 1
            # Fairness cap: a tenant over its byte share (with another
            # tenant resident) pays with its OWN oldest entries.  The
            # just-admitted entry is never the victim, so spill always
            # makes progress.
            if self.max_tenant_share < 1.0:
                cap = self.max_tenant_share * self.max_bytes
                while (len(self._tenant_bytes) >= 2
                       and self._tenant_bytes.get(tenant, 0) > cap):
                    victim = self._tenant_lru_locked(tenant, skip=digest)
                    if victim is None:
                        break
                    self._drop_locked(victim, lost=True)
            return True

    def take(self, digest: bytes) -> SpilledPrefix | None:
        """Remove and return the entry for ``digest`` (restore consumes
        the host copy — the device tier re-registers it on rehydrate,
        so keeping a stale duplicate would only burn host RAM)."""
        with self._lock:
            if digest not in self._entries:
                return None
            entry = self._drop_locked(digest, lost=False)
            self.restores += 1
            return entry

    def peek(self, digest: bytes) -> SpilledPrefix | None:
        """Entry for ``digest`` without consuming it (no LRU touch, no
        counter) — the engine validates geometry before committing device
        blocks to a restore."""
        with self._lock:
            return self._entries.get(digest)

    def contains(self, digest: bytes) -> bool:
        with self._lock:
            return digest in self._entries

    def clear(self) -> None:
        with self._lock:
            self.lost += len(self._entries)
            self._entries.clear()
            self._bytes = 0
            self._tenant_bytes.clear()

    def bytes_by_tenant(self) -> dict[str, int]:
        """Resident host-tier bytes per tenant (fairness accounting)."""
        with self._lock:
            return dict(self._tenant_bytes)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "spills": self.spills,
                "restores": self.restores,
                "lost": self.lost,
                "tenant_bytes": dict(self._tenant_bytes),
            }
