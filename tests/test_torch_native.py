"""The port's native host code (ghostm_tpu_torch/native.py over its own copy
of the C++, built by g++ into build/native/) against its Python / numpy
paths and against the JAX package on the same seeded inputs: the
counting-sort seed index, the keep mask, the FASTA reader, the m8 row
formatter (byte for byte: e-values that round across a decade, non-ASCII
utf-8 names, exact ties, neighbours of rounding boundaries, signed zeros,
subnormal and infinite e-values, integer extremes; its to_chars and
snprintf branches; no write past its buffer) and write_hits through a
SubjectNames.
Tolerance: exact equality (arrays and bytes)."""

import ctypes
import io
import logging
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest

from ghostm_tpu import native as jnative
from ghostm_tpu.config import Config as JConfig
from ghostm_tpu.engine import BatchHits as JBatchHits
from ghostm_tpu.index import seeds as jseeds
from ghostm_tpu.io.fasta import iter_fasta as jiter_fasta
from ghostm_tpu.ops.encode import encode_aa as jencode_aa
from ghostm_tpu.report import SubjectNames as JSubjectNames
from ghostm_tpu.report import write_hits as jwrite_hits
from ghostm_tpu_torch import native
from ghostm_tpu_torch.config import Config
from ghostm_tpu_torch.engine import BatchHits
from ghostm_tpu_torch.index import seeds
from ghostm_tpu_torch.ops import evalue as ev
from ghostm_tpu_torch.ops.encode import SENTINEL
from ghostm_tpu_torch.report import SubjectNames, _name_arena, write_hits

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def lib():
    if not native.available():
        pytest.fail("the port's host library did not build: these tests "
                    "need a C++ compiler ($CXX, default g++)")
    return native


def _numpy_csr(buf, k, keep=None):
    keys = seeds.kmer_keys(buf, k)
    valid = keys < 20**k
    if keep is not None:
        valid &= keep[: len(keys)]
    vkeys = keys[valid]
    vpos = np.nonzero(valid)[0].astype(np.int32)
    counts = np.bincount(vkeys, minlength=20**k)
    bucket_starts = np.zeros(20**k + 2, dtype=np.int64)
    np.cumsum(counts, out=bucket_starts[1 : 20**k + 1])
    bucket_starts[20**k + 1] = bucket_starts[20**k]
    order = np.argsort(vkeys, kind="stable")
    return vpos[order], bucket_starts.astype(np.int32)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_kmer_csr_matches_numpy_and_jax(lib, rng, k):
    buf = rng.integers(0, 26, size=5000).astype(np.int8)  # invalid codes too
    pos_c, bs_c = lib.kmer_csr(buf, k)
    pos_n, bs_n = _numpy_csr(buf, k)
    np.testing.assert_array_equal(pos_c, pos_n)
    np.testing.assert_array_equal(bs_c, bs_n)
    ref = jseeds.build_seed_index(buf, k)
    np.testing.assert_array_equal(pos_c, ref.positions)
    np.testing.assert_array_equal(bs_c, ref.bucket_starts)
    assert pos_c.dtype == bs_c.dtype == np.int32


def test_kmer_csr_keep_mask(lib, rng):
    buf = rng.integers(0, 20, size=2000).astype(np.int8)
    keep = rng.random(len(buf)) < 0.5
    pos_c, bs_c = lib.kmer_csr(buf, 3, keep)
    pos_n, bs_n = _numpy_csr(buf, 3, keep)
    np.testing.assert_array_equal(pos_c, pos_n)
    np.testing.assert_array_equal(bs_c, bs_n)
    ref = jseeds.build_seed_index(buf, 3, keep)
    np.testing.assert_array_equal(pos_c, ref.positions)
    np.testing.assert_array_equal(bs_c, ref.bucket_starts)


def test_build_seed_index_native_route_equals_numpy_and_jax(
        lib, rng, monkeypatch):
    """build_seed_index takes kmer_csr (counted as the native route); the
    numpy route gives the same index, and both equal the JAX package's."""
    buf = np.concatenate([
        rng.integers(0, 20, size=300).astype(np.int8),
        np.full(8, SENTINEL, np.int8),
        rng.integers(0, 25, size=300).astype(np.int8),
    ])
    keep = rng.random(len(buf)) < 0.7
    native.reset_calls()
    got = seeds.build_seed_index(buf, 3, keep)
    assert native.CALLS[("kmer_csr", "native")] == 1
    monkeypatch.setattr(native, "_load", lambda: None)
    slow = seeds.build_seed_index(buf, 3, keep)
    assert native.CALLS[("kmer_csr", "python")] == 1
    ref = jseeds.build_seed_index(buf, 3, keep)
    for idx in (slow, ref):
        np.testing.assert_array_equal(got.positions, idx.positions)
        np.testing.assert_array_equal(got.bucket_starts, idx.bucket_starts)


FASTA = (">s0 desc ignored\nARNDCQ\nEGHIK\n\n>s1\nmfpst*\n>empty\n>s3\tx\r\n"
         "WYV UOJ\r\nbzx\n>s4\n" + "ACDEFGHIKLMNPQRSTVWY" * 7 + "\n")


def test_fasta_reader_matches_jax(lib, tmp_path):
    p = tmp_path / "t.fa"
    p.write_text(FASTA)
    native.reset_calls()
    names, seqs = lib.read_fasta_protein(str(p))
    assert native.CALLS[("read_fasta_protein", "native")] == 1
    assert names == ["s0", "s1", "empty", "s3", "s4"]
    assert len(seqs[2]) == 0
    # the JAX package's native reader where its library loads, else its
    # Python reader (iter_fasta + encode_aa)
    ref = jnative.read_fasta_protein(str(p))
    if ref is None:
        recs = list(jiter_fasta(str(p)))
        ref = ([n for n, _ in recs], [jencode_aa(s) for _, s in recs])
    assert names == ref[0]
    for a, b in zip(seqs, ref[1]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int8
    assert lib.read_fasta_protein(str(tmp_path / "missing.fa")) is None


def _m8_columns(rng, n):
    pid = rng.random(n) * 100
    pid[:16] = [0.125, 99.995, 100.0, 0.005, 2.675, 33.335, 66.665, 0.0,
                12.345, 87.655, 0.015, 0.025, 49.995, 50.005, 1.115, 3.885]
    ev = 10.0 ** (rng.random(n) * 40 - 35)
    # rounding across a decade (9.996e-10 -> 1.00e-09), ties, extremes
    ev[:10] = [0.0, 1e-300, 9.996e-10, 2.5e-3, 9.999, 1.0, 9.9951e-5,
               0.0099999, 99.95, 1e-99]
    bits = rng.random(n) * 500
    bits[:6] = [0.05, 0.15, 0.25, 99.95, 123.45, 0.0]
    ints = [rng.integers(0, 2**31 - 1, n).astype(np.int32) for _ in range(3)]
    i64s = [rng.integers(-2**40, 2**40, n).astype(np.int64)
            for _ in range(4)]
    return pid, ints, i64s, ev, bits


def _around(*xs):
    """Each x with its float64 neighbours either side."""
    x = np.array(xs, np.float64)
    return np.concatenate([np.nextafter(x, -np.inf), x,
                           np.nextafter(x, np.inf)])


def _edge_columns(case, rng):
    """The m8 columns of one edge case, each list cycled to the longest:
    (pident, three int32 columns, four int64 columns, evalue, bits)."""
    k = np.arange(1601, dtype=np.float64)
    ints = [rng.integers(0, 100, 8).astype(np.int32) for _ in range(3)]
    i64s = [rng.integers(-2**40, 2**40, 8).astype(np.int64)
            for _ in range(4)]
    pid = ev = bits = np.array([1.0])
    if case == "ties":   # exact binary ties at each column's precision
        pid = np.concatenate([k[:801] / 8, k / 16, [2.5, 0.125, 0.375]])
        ev = np.concatenate([k[1:] / 8, k[1:] / 16, k[1:] / 1024])
        bits = np.concatenate([k / 4, [2.5, 0.125, 0.375]])
    elif case == "neighbours":   # either side of a rounding boundary
        pid = _around(0.005, 0.015, 0.125, 2.675, 49.995, 50.005, 99.995)
        ev = _around(9.995e-10, 9.9951e-5, 1.005e-5, 2.5e-3, 0.0099995,
                     9.995, 99.95, 9.995e+99)
        bits = _around(0.05, 0.15, 0.25, 99.95, 123.45, 999.95)
    elif case == "zeros_and_signs":
        pid = np.array([0.0, -0.0, -0.001, -0.004999, 100.0])
        ev = np.array([0.0, -0.0, 5e-324, 2.5e-310, 2.2250738585072014e-308,
                       np.inf, 1e+100, 1e-100, 1e-300, 1e-320,
                       1.7976931348623157e308])
        bits = np.array([0.0, -0.0, -0.04, -0.05, -0.01, -0.0499])
    elif case == "int_extremes":   # row 0: every integer at its minimum
        i32 = np.array([-2**31, 2**31 - 1, 0, -1, 1], np.int32)
        i64 = np.array([-2**63, 2**63 - 1, 0, -1, 2**31, -2**31 - 1],
                       np.int64)
        ints, i64s = [i32] * 3, [i64] * 4
    cols = (pid, *ints, *i64s, ev, bits)
    n = max(len(c) for c in cols)
    return tuple(np.resize(c, n) for c in cols)


M8_CASES = ["random", "ties", "neighbours", "zeros_and_signs",
            "int_extremes"]


def _m8_case(case):
    """(query names, subject names, qrow, srow, the ten numeric columns)
    of one case of the formatter's fuzz; utf-8 names in "random"."""
    rng = np.random.default_rng(0)
    if case == "random":
        pid, ints, i64s, ev, bits = _m8_columns(rng, 4096)
        cols = (pid, *ints, *i64s, ev, bits)
    else:
        cols = _edge_columns(case, rng)
    n = len(cols[0])
    qnames = [f"q{i}" + ("_é" if i % 7 == 0 else "") for i in range(n)]
    snames = [f"subj_{i}" + ("_名前" if i % 5 == 0 else "")
              for i in range(n)]
    qrow = np.arange(n, dtype=np.int32)
    return qnames, snames, qrow, qrow[::-1].copy(), cols


def _py_m8(qnames, snames, qrow, srow, cols):
    """The rows as report.write_hits's Python loop writes them."""
    return "".join(
        f"{qnames[q]}\t{snames[s]}\t{p:.2f}\t{ln}\t{mm}\t{go}\t{qs}\t{qe}\t"
        f"{ss}\t{se}\t{e:.2e}\t{b:.1f}\n"
        for q, s, p, ln, mm, go, qs, qe, ss, se, e, b in zip(
            qrow.tolist(), srow.tolist(), *(c.tolist() for c in cols)))


def _c_m8(fmt, case):
    """(the rows through `fmt`, a native.m8_format-like formatter, the
    rows as the Python loop writes them) for one case."""
    qnames, snames, qrow, srow, cols = _m8_case(case)
    qarena, qoff = _name_arena(qnames)
    sarena, soff = _name_arena(snames)
    got = fmt(qrow, qarena, qoff, srow, sarena, soff, *cols)
    return got, _py_m8(qnames, snames, qrow, srow, cols)


@pytest.mark.parametrize("case", M8_CASES)
def test_m8_format_fuzz_matches_python(lib, case):
    """The C formatter reproduces CPython's f-string bytes for every column
    format, utf-8 names included: random rows, exact binary ties at each
    precision, float64 neighbours of rounding boundaries, signed zeros,
    subnormal, infinite and 3-digit-exponent e-values, and int32 / int64
    extremes. The JAX package's formatter (where its library loads) writes
    the same bytes."""
    got, want = _c_m8(lib.m8_format, case)
    assert got.decode() == want
    if case == "random":
        assert "1.00e-09" in want   # the decade case is in the data
    if case == "zeros_and_signs":
        assert "\t-0.00\t" in want and "\t-0.0\n" in want
        assert "\tinf\t" in want and "\t4.94e-324\t" in want
        assert "\t1.00e+100\t" in want and "\t1.00e-300\t" in want
    if case == "ties":
        assert "\t0.12\t" in want and "\t1.12e+00\t" in want
    ref, _ = _c_m8(jnative.m8_format, case)
    if ref is not None:
        assert got == ref


def test_m8_format_empty_call(lib):
    """No rows: b"" without a call into C."""
    qnames, snames, qrow, srow, cols = _m8_case("ties")
    qarena, qoff = _name_arena(qnames)
    sarena, soff = _name_arena(snames)
    assert lib.m8_format(qrow[:0], qarena, qoff, srow[:0], sarena, soff,
                         *(c[:0] for c in cols)) == b""


def _wide_rows(col, value):
    """native.m8_format's arguments for two rows, the second with column
    `col` ("pident" or "bits") set to `value`."""
    qarena, qoff = _name_arena(["q0", "q1"])
    sarena, soff = _name_arena(["s0", "s1"])
    rows = np.arange(2, dtype=np.int32)
    i4, i8 = np.ones(2, np.int32), np.ones(2, np.int64)
    f8 = {c: np.ones(2) for c in ("pident", "evalue", "bits")}
    f8[col][1] = value
    return (rows, qarena, qoff, rows, sarena, soff, f8["pident"], i4, i4,
            i4, i8, i8, i8, i8, f8["evalue"], f8["bits"])


def _raw_m8(clib, args, slack=64):
    """m8_format_rows called directly with the cap native.m8_format gives,
    into a buffer `slack` bytes longer filled with 0xAB: (returned, the
    buffer's bytes, cap)."""
    qrow, qarena, qoff, srow, sarena, soff, *cols = args
    cap = len(qarena) + len(sarena) + 160 * len(qrow)
    buf = ctypes.create_string_buffer(b"\xab" * (cap + slack))
    p = ctypes.c_void_p
    w = clib.m8_format_rows(
        len(qrow), qrow.ctypes.data_as(p), qarena, qoff.ctypes.data_as(p),
        srow.ctypes.data_as(p), sarena, soff.ctypes.data_as(p),
        *(c.ctypes.data_as(p) for c in cols), buf, cap)
    return w, buf.raw[: cap + slack], cap


@pytest.mark.parametrize("col", ["pident", "bits"])
def test_m8_format_value_too_wide_raises(lib, col):
    """A value whose fixed notation cannot fit the row's reserve (1e200:
    201 digits) makes m8_format_rows return -1, which native.m8_format
    raises as RuntimeError, and nothing is written past the cap; a wide
    value that fits (1e20) is written whole."""
    w, raw, cap = _raw_m8(lib._lib, _wide_rows(col, 1e200))
    assert w == -1 and raw[cap:] == b"\xab" * 64
    with pytest.raises(RuntimeError, match="m8_format_rows"):
        lib.m8_format(*_wide_rows(col, 1e200))
    got = lib.m8_format(*_wide_rows(col, 1e20))
    assert b"\t100000000000000000000.0" in got and b"\0" not in got


def _has_to_chars(cxx):
    """Whether the compiler's C++ library has floating-point to_chars."""
    r = subprocess.run([cxx, "-std=c++17", "-E", "-x", "c++", "-"],
                       input="#include <charconv>\n__cpp_lib_to_chars\n",
                       capture_output=True, text=True, check=True)
    last = r.stdout.strip().splitlines()[-1]
    return last != "__cpp_lib_to_chars" and int(last.rstrip("L")) >= 201611


def test_m8_format_snprintf_fallback_same_bytes(lib, tmp_path, monkeypatch):
    """The snprintf loop, which a compiler without floating-point to_chars
    builds (-DGHOSTM_M8_SNPRINTF forces it here; built into tmp_path),
    writes the bytes of the default build on every fuzz case and refuses
    the same too-wide value; the default build calls to_chars exactly when
    the compiler's library has it."""
    cxx = os.environ.get("CXX", "g++")
    default = Path(lib._lib._name).read_bytes()
    assert (b"to_chars" in default) == _has_to_chars(cxx)
    want = {case: _c_m8(lib.m8_format, case)[0] for case in M8_CASES}
    monkeypatch.setattr(native, "CXXFLAGS",
                        native.CXXFLAGS + ("-DGHOSTM_M8_SNPRINTF",))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    path = Path(native._lib._name)
    assert path.parent == tmp_path
    assert b"to_chars" not in path.read_bytes()
    for case in M8_CASES:
        assert _c_m8(native.m8_format, case)[0] == want[case], case
    w, raw, cap = _raw_m8(native._lib, _wide_rows("bits", 1e200))
    assert w == -1 and raw[cap:] == b"\xab" * 64


def _hits(seed=7, R=128, K=5, nsub=500):
    rng2 = np.random.default_rng(seed)
    z = np.zeros((R, K), np.int32)
    fields = (
        rng2.integers(0, 120, (R, K)).astype(np.int32),
        rng2.integers(0, nsub, (R, K)).astype(np.int32),
        rng2.integers(0, 6, (R, K)).astype(np.int32),
        rng2.integers(10, 33, (R, K)).astype(np.int32),
        rng2.integers(50, 300, (R, K)).astype(np.int32),
        rng2.integers(10, 33, (R, K)).astype(np.int32), z, z, z,
    )
    stats = {
        k: rng2.integers(0, 30, (R, K)).astype(np.int32)
        for k in ("qstart", "qend", "sstart", "send", "length", "matches",
                  "mismatch", "gapopen")
    }
    stats["length"] = np.maximum(stats["length"], 1)
    return fields, stats


def _writer_case(case, R, K):
    """write_hits inputs for one case: (fields, stats, read lengths,
    config kwargs). "one_length": every read 100 bp; "many_lengths": 2-250
    bp, reads under 3 bp among them (their qlen_aa floors at 1), scored
    with PAM30 9/1, whose larger H makes the length adjustment vary over
    these lengths (BLOSUM62's is the same for every query this short);
    "none_kept": an e-value cutoff no hit meets; "empty_neighbours": every
    other hit an empty alignment (ie < 0: coordinates -1, zero stats) with
    a zero or negative score, beside kept hits."""
    fields, stats = _hits(R=R, K=K)
    rng2 = np.random.default_rng(11)
    lens = np.full(R, 100, np.int32)
    kw = {}
    if case == "many_lengths":
        lens = rng2.integers(2, 251, R).astype(np.int32)
        lens[:3] = (2, 2, 5)
        kw = dict(matrix="PAM30", gap_open=9, gap_extend=1)
    elif case == "none_kept":
        kw["evalue_cutoff"] = 1e-300
    elif case == "empty_neighbours":
        empty = np.zeros((R, K), bool)
        empty[:, 1::2] = True
        fields = list(fields)
        fields[0] = np.where(empty, -rng2.integers(0, 2, (R, K)),
                             fields[0]).astype(np.int32)
        for k in ("qstart", "qend", "sstart", "send"):
            stats[k] = np.where(empty, -1, stats[k]).astype(np.int32)
        for k in ("length", "matches", "mismatch", "gapopen"):
            stats[k] = np.where(empty, 0, stats[k]).astype(np.int32)
    return fields, stats, lens, kw


@pytest.mark.parametrize("case", ["one_length", "many_lengths", "none_kept",
                                  "empty_neighbours"])
def test_write_hits_native_equals_python_and_jax(lib, case):
    """write_hits with a SubjectNames (the C formatter) writes the bytes of
    the Python loop (a plain dict) and of the JAX package's write_hits
    (both routes), with non-ASCII utf-8 names: at one read length, at many
    (the length adjustment solved once for each), with no row kept, and
    with empty alignments and non-positive scores beside the kept hits."""
    R, K = 128, 5
    fields, stats, lens, kw = _writer_case(case, R, K)
    names = [f"read{i}" + ("_ü" if i % 3 == 0 else "") for i in range(R)]
    d = {i: f"s{i}" + ("_ß" if i % 4 == 0 else "") for i in range(500)}
    outs, rows = [], []
    for wh, Cfg, BH, SN in ((write_hits, Config, BatchHits, SubjectNames),
                            (jwrite_hits, JConfig, JBatchHits,
                             JSubjectNames)):
        cfg = Cfg(query_batch=R, seed_len=4, **kw)
        for sn in (d, SN(d)):
            b = io.StringIO()
            rows.append(wh(b, cfg, names, lens, sn, BH(*fields), stats,
                           10**6, 500))
            outs.append(b.getvalue())
    native.reset_calls()
    timing = {}
    b = io.StringIO()
    rows.append(write_hits(b, Config(query_batch=R, seed_len=4, **kw), names,
                           lens, SubjectNames(d), BatchHits(*fields), stats,
                           10**6, 500, timing=timing))
    assert len(set(rows)) == 1
    assert all(o == outs[0] for o in outs + [b.getvalue()])
    assert timing["evalue_lengths"] == np.unique(
        np.maximum(lens // 3, 1)).size
    assert timing["evalue_s"] <= timing["columns_s"]
    if case == "none_kept":
        assert rows[0] == 0 and outs[0] == ""
        assert set(timing) == {"columns_s", "evalue_s", "evalue_lengths"}
        return
    assert rows[0] > 0
    assert native.CALLS[("m8_format", "native")] == 1
    assert set(timing) == {"columns_s", "evalue_s", "evalue_lengths",
                           "format_s", "names_s", "write_s"}
    assert timing["names_s"] <= timing["format_s"]
    if case == "one_length":
        assert timing["evalue_lengths"] == 1
    if case == "many_lengths":
        assert timing["evalue_lengths"] > 50
        _, kk, kh = Config(**kw).ka_params()
        assert np.unique(ev.length_adjustment(
            kk, kh, np.maximum(lens // 3, 1), 10**6, 500)).size > 1
        assert any(ln.split("\t")[0] == "read0_ü" for ln in
                   outs[0].splitlines())   # a 2 bp read has a row
    if case == "empty_neighbours":
        # no empty alignment is kept: no row has a -1 coordinate
        assert "\t-1\t" not in outs[0]


def test_python_route_without_a_compiler(tmp_path, monkeypatch, caplog):
    """No compiler: one warning, every function returns None (counted as
    the Python route), and write_hits through a SubjectNames writes the
    bytes of the native route."""
    fields, stats = _hits()
    d = {i: f"s{i}" for i in range(500)}
    names = [f"read{i}" for i in range(128)]
    lens = np.full(128, 100, np.int32)
    cfg = Config(query_batch=128, seed_len=4)
    want = io.StringIO()
    assert native.available()
    write_hits(want, cfg, names, lens, SubjectNames(d), BatchHits(*fields),
               stats, 10**6, 500)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    native.reset_calls()
    with caplog.at_level(logging.WARNING, logger="ghostm_tpu_torch.native"):
        assert not native.available()
        assert not native.available()
        got = io.StringIO()
        write_hits(got, cfg, names, lens, SubjectNames(d),
                   BatchHits(*fields), stats, 10**6, 500)
        assert native.kmer_csr(np.zeros(10, np.int8), 2) is None
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "no C++ compiler" in warnings[0].message
    assert native.CALLS[("m8_format", "python")] == 1
    assert native.CALLS[("kmer_csr", "python")] == 1
    assert got.getvalue() == want.getvalue()


def test_library_builds_into_build_native(lib):
    """The port loads its own build of its own source from build/native/,
    named by a hash of the source, compiler and flags; never the JAX
    package's native/libghostm_native.so."""
    path = Path(lib._lib._name).resolve()
    assert path.parent == ROOT / "build" / "native"
    assert path == lib.lib_path(os.environ.get("CXX", "g++")).resolve()
    assert path.name.startswith("libghostm_native-") and path.suffix == ".so"
    assert lib.SOURCE == ROOT / "ghostm_tpu_torch" / "csrc" / "host" \
        / "ghostm_native.cpp"
    assert (ROOT / "native") not in path.parents
