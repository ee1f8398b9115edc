"""How ``correct`` is decided: a sample of the reads the window drained,
drawn from the seed, run through the plain reference
(``perfbench/reference``) from the benchmark's own raw signal, sequences,
pore table and weight tensors, and compared with what the timed path
produced: its calls in memory and, where the cell writes one, its BAM.

Numbers compared (each against the configuration's limit), over the
centre-T call sites of the sampled reads, a site being a reference
coordinate with its k-mer, and a site's gap the larger of its BrdU and EdU
probability gaps, or 1 where one side lacks the site (places it at another
k-mer, or loses it with its read to QC):

* ``call_gap_mean``: the mean gap over the union of both sides' sites;
* ``call_gap_p99``: the 99th percentile of those gaps;
* with a writer, ``bam_call_gap_mean`` and ``bam_call_gap_p99``: the same
  over the written BAM's MM/ML tags, sites keyed by query index (ML holds
  trunc(255 p), so its gaps carry up to 1/255 of truncation).

A configuration may list some of these under ``printed``: shown, not
compared, where the control does not read three times what sound runs do.
Printed beside them, not compared: ``prob_gap``, the widest gap at a site
both sides have (the bf16 CNN's widest gap overlaps the fp8 control's, so
no limit separates them), and ``sites_off``, the share of the union that
one side lacks.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .reference import cnn as ref_cnn, pipeline as ref_pipe


def sample_reads(drained: dict, pool: list, n: int, seed: int) -> list[int]:
    """Pool indices to check: the longest drained read, one drained noise
    read where there is one, then others drawn from the seed."""
    idx = sorted(drained)
    if not idx:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 63), 77])
    chosen = [max(idx, key=lambda i: (pool[i].length, -i))]
    noise = [i for i in idx if pool[i].noise and i not in chosen]
    if noise:
        chosen.append(noise[int(rng.integers(len(noise)))])
    rest = [i for i in idx if i not in chosen]
    rng.shuffle(rest)
    return chosen + rest[: max(0, n - len(chosen))]


def reference_inputs(read) -> dict:
    """The reference's view of a pool read: all-M and error-free, so the
    coordinate maps are identities."""
    L = read.length
    seq = read.seq
    ident = np.arange(L + 1, dtype=np.int64)
    return dict(raw=read.raw, seq=seq, refseq_seq=seq, r2q=ident,
                q2r=ident[:L], ref_start=read.ref_start,
                ref_end=read.ref_start + L, is_reverse=read.is_reverse)


def reference_calls(reads: list, config: dict, pore: np.ndarray,
                    tensors: dict, device, control: bool = False) -> list:
    """Per read None (QC failed) or (coords, kmer_starts, query_idx,
    probs (Ct, 2) [BrdU, EdU]).  ``control`` computes everything one
    precision step below what the configuration states: the banded DP and
    the Viterbi in bf16 (stated f32), the CNN's bf16 layers in fp8 and its
    f32 GRU matmuls in TF32."""
    pos = ref_pipe.prepare([reference_inputs(r) for r in reads], pore,
                           bf16=control)
    probs = ref_cnn.probabilities(ref_cnn.build(config, tensors, control),
                                  pos, device,
                                  chunk=int(config["cnn_chunk_positions"]))
    out = []
    for p, pr in zip(pos, probs):
        if p is None:
            out.append(None)
            continue
        t = p.center_t
        out.append((p.coord[t], p.kmer_start[t], p.query_idx[t], pr))
    return out


def _compare(sides: list) -> dict:
    """sides: per read (program {site: (key, brdu, edu)} or None,
    reference the same or None)."""
    gaps, missing = [], 0
    for prog, ref in sides:
        prog = prog or {}
        ref = ref or {}
        for k in set(prog) | set(ref):
            a, b = prog.get(k), ref.get(k)
            if a is None or b is None or a[0] != b[0]:
                missing += 1
            else:
                gaps.append(max(abs(a[1] - b[1]), abs(a[2] - b[2])))
    union = len(gaps) + missing
    every = np.concatenate([np.asarray(gaps, np.float64), np.ones(missing)])
    return dict(call_gap_mean=float(every.mean()) if union else 0.0,
                call_gap_p99=float(np.quantile(every, 0.99)) if union
                else 0.0,
                prob_gap=float(max(gaps)) if gaps else 0.0,
                sites_off=missing / union if union else 0.0,
                sites=union)


def _ref_sites(r, by="coord"):
    if r is None:
        return None
    coords, ks, qidx, pr = r
    keys = coords if by == "coord" else qidx
    return {int(c): (int(k), float(p[0]), float(p[1]))
            for c, k, p in zip(keys, ks, pr)}


def compare_memory(program: list, reference: list) -> dict:
    """``program``: per read the DetectedRead or None."""
    sides = []
    for d, r in zip(program, reference):
        prog = None
        if d is not None:
            prog = {int(c): (int(k), float(b), float(e)) for c, k, b, e in
                    zip(d.ref_coords, d.kmer_starts, d.brdu_prob, d.edu_prob)}
        sides.append((prog, _ref_sites(r)))
    return _compare(sides)


def compare_bam(records: dict, read_ids: list, reference: list) -> dict:
    """``records``: {read id: (query indices, brdu u8, edu u8)} parsed
    from the written BAM."""
    sides = []
    for rid, r in zip(read_ids, reference):
        got = records.get(rid)
        prog = None
        if got is not None:
            q, b, e = got
            prog = {int(qi): (0, bi / 255.0, ei / 255.0)
                    for qi, bi, ei in zip(q, b, e)}
        ref = None
        if r is not None:
            ref = {k: (0, v[1], v[2]) for k, v in _ref_sites(r, "q").items()}
        sides.append((prog, ref))
    return {"bam_" + k: v for k, v in _compare(sides).items()}


# ---------------------------------------------------------------------------
# BAM read-back (BGZF + records + the MM/ML tags), the benchmark's own
# ---------------------------------------------------------------------------

def _inflate_bgzf(path: str) -> bytes:
    out = bytearray()
    with open(path, "rb") as fh:
        data = fh.read()
    o = 0
    while o + 18 <= len(data):
        xlen = struct.unpack_from("<H", data, o + 10)[0]
        bsize = struct.unpack_from("<H", data, o + 16)[0]
        cstart = o + 12 + xlen
        out += zlib.decompress(data[cstart : o + bsize + 1 - 8], wbits=-15)
        o += bsize + 1
    return bytes(out)


def _aux(buf: bytes, o: int, end: int) -> dict:
    sizes = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4, b"f": 4,
             b"A": 1}
    tags = {}
    while o < end:
        tag, typ = buf[o : o + 2].decode(), buf[o + 2 : o + 3]
        o += 3
        if typ in (b"Z", b"H"):
            z = buf.index(b"\x00", o)
            tags[tag] = buf[o:z].decode()
            o = z + 1
        elif typ == b"B":
            sub = buf[o : o + 1]
            n = struct.unpack_from("<I", buf, o + 1)[0]
            o += 5
            w = sizes[sub]
            if sub == b"C":
                tags[tag] = np.frombuffer(buf, np.uint8, n, o).copy()
            o += n * w
        else:
            o += sizes[typ]
    return tags


def read_modbam(path: str, wanted: set) -> dict:
    """{read id: (query indices, BrdU u8, EdU u8)} of the first record of
    each wanted read, from the MM (``N+b?`` / ``N+e?``) and ML tags."""
    buf = _inflate_bgzf(path)
    l_text = struct.unpack_from("<i", buf, 4)[0]
    o = 8 + l_text
    n_ref = struct.unpack_from("<i", buf, o)[0]
    o += 4
    for _ in range(n_ref):
        o += 4 + struct.unpack_from("<i", buf, o)[0] + 4
    out = {}
    while o + 4 <= len(buf):
        size = struct.unpack_from("<i", buf, o)[0]
        r = o + 4
        o = r + size
        l_name, n_cig, l_seq = buf[r + 8], struct.unpack_from(
            "<H", buf, r + 12)[0], struct.unpack_from("<i", buf, r + 16)[0]
        name = buf[r + 32 : r + 32 + l_name - 1].decode()
        if name not in wanted or name in out:
            continue
        a = r + 32 + l_name + 4 * n_cig + (l_seq + 1) // 2 + l_seq
        tags = _aux(buf, a, o)
        fields = {}
        for spec in tags.get("MM", "").split(";"):
            if spec:
                parts = spec.split(",")
                fields[parts[0]] = [int(x) for x in parts[1:]]
        deltas = fields.get("N+b?", [])
        q, prev = [], 0
        for d in deltas:
            q.append(prev + d)
            prev = q[-1] + 1
        ml = tags.get("ML", np.zeros(0, np.uint8))
        n = len(q)
        out[name] = (np.asarray(q, np.int64), ml[:n], ml[n : 2 * n])
    return out


def verdict(numbers: dict, limits: dict,
            printed=()) -> tuple[bool, dict]:
    """(all within their limits, {name: {value, limit}}) over the numbers
    that have a limit; ``printed`` names numbers the configuration shows
    but does not compare (no control reading separates them from sound
    runs); any other number without a limit is refused."""
    shown = {}
    ok = True
    for name, value in numbers.items():
        if name.endswith(("sites", "sites_off", "prob_gap")) \
                or name in printed:
            continue
        if name not in limits:
            raise KeyError(f"no limit for compared number {name!r}")
        shown[name] = {"value": value, "limit": limits[name]}
        ok &= bool(value <= limits[name])
    return ok, shown
