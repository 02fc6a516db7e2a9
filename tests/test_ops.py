"""Unit tests: encoding, translation, scoring tables, E-values (SURVEY.md §4.2)."""

import numpy as np
import pytest

from ghostm_tpu.ops import encode, evalue, scoring, translate


def test_encode_aa_roundtrip():
    s = "ARNDCQEGHILKMFPSTWYVBZX*"
    codes = encode.encode_aa(s)
    assert list(codes) == list(range(24))
    assert encode.decode_aa(codes) == s


def test_encode_aa_unknown_and_case():
    assert encode.encode_aa("a")[0] == 0
    assert encode.encode_aa("?")[0] == encode.AA_X
    assert encode.encode_aa("U")[0] == encode.encode_aa("C")[0]


def test_encode_dna():
    assert list(encode.encode_dna("ACGTacgtN?")) == [0, 1, 2, 3, 0, 1, 2, 3, 4, 4]


def test_blosum62_spot_values():
    b = scoring.BLOSUM62
    aa = {c: i for i, c in enumerate(encode.AA_ALPHABET)}
    # Canonical NCBI BLOSUM62 entries.
    assert b[aa["W"], aa["W"]] == 11
    assert b[aa["A"], aa["A"]] == 4
    assert b[aa["C"], aa["C"]] == 9
    assert b[aa["A"], aa["R"]] == -1
    assert b[aa["W"], aa["Y"]] == 2
    assert b[aa["D"], aa["E"]] == 2
    assert b[aa["I"], aa["L"]] == 2
    assert b[aa["*"], aa["*"]] == 1
    assert b[aa["A"], aa["*"]] == -4
    assert (b == b.T).all()


def test_all_matrices_properties():
    """Every shipped matrix: 24x24 symmetric int, * row constant negative
    except the *-* corner, X column within [-6, 0], and the documented
    score ranges (which decide the fused-kernel nibble packing)."""
    from ghostm_tpu.kernels.sw_fused import build_packed_matrix

    aa = {c: i for i, c in enumerate(encode.AA_ALPHABET)}
    ranges = {
        "BLOSUM45": (-5, 15), "BLOSUM50": (-5, 15), "BLOSUM62": (-4, 11),
        "BLOSUM80": (-6, 11), "BLOSUM90": (-6, 11), "PAM30": (-17, 13),
        "PAM70": (-11, 13), "PAM250": (-8, 17),
    }
    assert set(scoring.MATRICES) == set(ranges)
    for name, m in scoring.MATRICES.items():
        assert m.shape == (24, 24) and (m == m.T).all(), name
        assert int(m.min()) == ranges[name][0], name
        assert int(m.max()) == ranges[name][1], name
        star = m[aa["*"]]
        assert (star[:-1] == star[0]).all() and star[0] < 0, name
        assert star[-1] == 1, name
        assert m.diagonal()[:22].min() >= 2, name  # real AAs + B/Z (not X/*)
        # only BLOSUM62 fits the fused kernel's [-4, 11] nibble range;
        # every other matrix must signal the score-fed fallback
        words, _ = build_packed_matrix(scoring.padded_matrix(name))
        assert (words is not None) == (name == "BLOSUM62"), name


def test_matrix_pinned_values():
    """Spot values transcribed from the NCBI data files, pinned per
    matrix (SURVEY.md §2 'Substitution matrix'; mount empty, values are
    the NCBI standard)."""
    aa = {c: i for i, c in enumerate(encode.AA_ALPHABET)}

    def chk(name, pairs):
        m = scoring.MATRICES[name]
        for a, b, want in pairs:
            assert m[aa[a], aa[b]] == want, (name, a, b)

    chk("BLOSUM45", [("W", "W", 15), ("A", "A", 5), ("C", "C", 12),
                     ("R", "K", 3), ("N", "B", 4), ("D", "B", 5),
                     ("I", "V", 3), ("W", "Y", 3)])
    chk("BLOSUM50", [("W", "W", 15), ("A", "A", 5), ("C", "C", 13),
                     ("P", "P", 10), ("H", "H", 10), ("D", "F", -5),
                     ("F", "Y", 4), ("I", "V", 4), ("L", "M", 3)])
    chk("BLOSUM80", [("W", "W", 11), ("A", "A", 5), ("C", "C", 9),
                     ("H", "H", 8), ("D", "W", -6), ("E", "Q", 2),
                     ("I", "V", 3), ("R", "K", 2)])
    chk("BLOSUM90", [("W", "W", 11), ("A", "A", 5), ("C", "C", 9),
                     ("Y", "Y", 8), ("E", "C", -6), ("D", "W", -6),
                     ("I", "V", 3), ("H", "Y", 1)])
    chk("PAM30", [("W", "W", 13), ("M", "M", 11), ("C", "C", 10),
                  ("A", "W", -13), ("E", "W", -17), ("D", "B", 6),
                  ("L", "M", 1), ("S", "A", 0)])
    chk("PAM70", [("W", "W", 13), ("M", "M", 10), ("C", "C", 9),
                  ("D", "D", 6), ("E", "W", -11), ("F", "Y", 4),
                  ("R", "W", 0), ("N", "D", 3)])
    chk("PAM250", [("W", "W", 17), ("C", "C", 12), ("Y", "Y", 10),
                   ("F", "Y", 7), ("R", "W", 2), ("A", "A", 2),
                   ("D", "E", 3), ("H", "Q", 3)])


def test_translate_device_matches_host(rng):
    """six_frame_translate_jnp (the in-program device path) is
    bit-identical to the numpy host path across read lengths 0..L,
    ambiguous bases, and frame truncation."""
    import jax.numpy as jnp

    R, L = 64, 100
    dna = rng.integers(0, 5, (R, L)).astype(np.int8)  # incl. N
    lens = rng.integers(0, L + 1, R).astype(np.int64)
    lens[:8] = [0, 1, 2, 3, 4, L, L - 1, 50]
    for frame_len in (40, 20, 64):
        host = translate.six_frame_translate(dna, lens, frame_len)
        dev = np.asarray(translate.six_frame_translate_jnp(
            jnp.asarray(dna), jnp.asarray(lens.astype(np.int32)), frame_len
        ))
        assert host.shape == dev.shape
        assert (host == dev).all()


def test_padded_matrix_sentinels():
    m = scoring.padded_matrix(hard_stop=True)
    assert m.shape == (32, 32)
    assert (m[encode.SENTINEL] == scoring.LOW).all()
    assert (m[:, encode.PAD] == scoring.LOW).all()
    assert (m[encode.AA_STOP] == scoring.LOW).all()
    soft = scoring.padded_matrix(hard_stop=False)
    assert soft[encode.AA_STOP, encode.AA_STOP] == 1


def _translate_str(dna: str, frame_len=40):
    codes = encode.encode_dna(dna)[None, :]
    out = translate.six_frame_translate(codes, np.array([len(dna)]), frame_len)
    return [
        encode.decode_aa(out[0, f]).rstrip(".")  # '.' = PAD
        for f in range(6)
    ]


def test_translate_known_frames():
    # ATG GCC TGA -> frame0: M A *
    frames = _translate_str("ATGGCCTGA")
    assert frames[0] == "MA*"
    # frame 1: TGG CCT GA -> W P
    assert frames[1] == "WP"
    # frame 2: GGC CTG A -> G L
    assert frames[2] == "GL"
    # revcomp of ATGGCCTGA = TCAGGCCAT; frame3: TCA GGC CAT -> S G H
    assert frames[3] == "SGH"
    assert frames[4] == "QA"    # CAG GCC (AT)
    assert frames[5] == "RP"    # AGG CCA T


def test_translate_ambiguous_to_x():
    frames = _translate_str("ATGNNATGA")
    assert frames[0][1] == "X"


def test_translate_batch_lengths():
    dna = np.zeros((2, 12), dtype=np.int8)
    out = translate.six_frame_translate(dna, np.array([12, 5]), 10)
    # read 1 has only 1 codon in frame 0 (len 5 -> 1 codon)
    assert (out[1, 0, 1:] == encode.PAD).all()
    assert out[1, 0, 0] == encode.encode_aa("K")[0]  # AAA -> K


def test_evalue_monotone():
    e = evalue.e_value(np.array([30, 60]), np.array([30, 30]), 10**6, 0.267, 0.041)
    assert e[0] > e[1] > 0
    b = evalue.bit_score(np.array([60]), 0.267, 0.041)
    assert 26 < b[0] < 28  # (0.267*60 - ln 0.041)/ln2 ~ 27.7


def test_ka_params_published_values():
    """Pin (lambda, K, H) to the published NCBI BLAST BLOSUM62 table
    (blast_stat.c BLOSUM62_VALUES) for the common gap settings."""
    assert evalue.params_for("BLOSUM62", 11, 1) == (0.267, 0.041, 0.14)
    assert evalue.params_for("BLOSUM62", 12, 1) == (0.283, 0.059, 0.19)
    assert evalue.params_for("BLOSUM62", 10, 1) == (0.243, 0.024, 0.10)
    assert evalue.params_for("BLOSUM62", 11, 2) == (0.297, 0.082, 0.27)
    with pytest.raises(ValueError):
        evalue.params_for("BLOSUM62", 5, 5)
    from ghostm_tpu.config import Config
    with pytest.raises(ValueError):
        Config(gap_open=5, gap_extend=5)
    assert Config().ka_params() == (0.267, 0.041, 0.14)
    # explicit overrides win (mirroring a reference run's constants)
    assert Config(ka_lambda=0.3, ka_k=0.05).ka_params()[:2] == (0.3, 0.05)


def test_ka_params_other_matrices():
    """Pin the non-BLOSUM62 gapped tables (blast_stat.c
    BLOSUM{45,50,80,90}_VALUES / PAM{30,70,250}_VALUES defaults: the gap
    settings blastp uses by default for each matrix)."""
    assert evalue.params_for("BLOSUM45", 15, 2) == (0.203, 0.041, 0.12)
    assert evalue.params_for("BLOSUM50", 13, 2) == (0.193, 0.035, 0.12)
    assert evalue.params_for("BLOSUM80", 10, 1) == (0.299, 0.071, 0.27)
    assert evalue.params_for("BLOSUM90", 10, 1) == (0.290, 0.075, 0.28)
    assert evalue.params_for("PAM30", 9, 1) == (0.294, 0.11, 0.61)
    assert evalue.params_for("PAM70", 10, 1) == (0.291, 0.091, 0.41)
    assert evalue.params_for("PAM250", 14, 2) == (0.182, 0.024, 0.073)
    # unknown gap combos for a known matrix name the known ones
    with pytest.raises(ValueError, match="BLOSUM80"):
        evalue.params_for("BLOSUM80", 3, 3)
    # every table row is a plausible KA fit: lambda, K, H all positive and
    # lambda below the matrix's ungapped lambda (gapping loosens the fit)
    for (m, _, _), (lam, k, h) in evalue.GAPPED_PARAMS.items():
        assert 0 < lam <= evalue.UNGAPPED_PARAMS[m][0]
        assert 0 < k < 1 and 0 < h < 2


def test_evalue_length_adjustment():
    """BLAST finite-size correction: effective lengths shrink the search
    space (E smaller), are floored at 1/K for short queries, and the
    adjustment grows with the database."""
    lam, k, h = 0.267, 0.041, 0.14
    raw = np.array([50])
    qlen = np.array([33])
    n, nseq = 26778, 100
    e_plain = evalue.e_value(raw, qlen, n, lam, k)
    e_corr = evalue.e_value(raw, qlen, n, lam, k, h=h, db_seqs=nseq)
    assert 0 < e_corr[0] < e_plain[0]
    ell = evalue.length_adjustment(k, h, np.array([33.0]), n, nseq)
    assert 0 < ell[0] < n / nseq
    # short query saturates at the 1/K floor: E uses m_eff = 1/K
    want = k * (1.0 / k) * max(n - nseq * ell[0], 1.0 / k) * np.exp(-lam * 50)
    np.testing.assert_allclose(e_corr[0], want, rtol=1e-12)
    ell_big = evalue.length_adjustment(k, h, np.array([500.0]), 1e9, 100000)
    assert ell_big[0] > ell[0]


@pytest.mark.parametrize("lengths", ["repeated", "one"])
def test_port_length_adjustment_distinct_solve_bit_equal(lengths):
    """The port's length_adjustment solves once for each distinct query
    length and indexes back: bit-equal (np.array_equal on float64) to the
    20-iteration fixed point over the full repeated array, written out
    here; and the port's e_value with per-read lengths (R, 1) against
    per-hit scores (R, K) equals the per-hit solve."""
    from ghostm_tpu_torch.ops import evalue as tevalue

    lam, k, h = 0.267, 0.041, 0.14
    n, nseq = 206_000_000.0, 570_000
    rng = np.random.default_rng(3)
    if lengths == "one":
        qlen = np.full(8192, 33, np.int64)
    else:
        # 300 distinct lengths up to Swiss-Prot's, each repeated: past
        # ~140 aa the adjustment varies with the length
        qlen = rng.choice(rng.choice(np.arange(1, 3000), 300,
                                     replace=False), 8192)
    m = np.repeat(qlen, 10).astype(np.float64)
    ell = np.zeros_like(m)
    for _ in range(20):
        me = np.maximum(m - ell, 1.0 / k)
        ne = np.maximum(n - nseq * ell, 1.0 / k)
        ell = np.clip((np.log(k) + np.log(me * ne)) / h, 0.0, None)
    want = np.floor(ell)
    if lengths == "repeated":
        assert np.unique(want).size > 10   # the adjustment varies
    got = tevalue.length_adjustment(k, h, m, n, nseq)
    assert got.shape == m.shape and np.array_equal(got, want)
    assert np.array_equal(
        tevalue.length_adjustment(k, h, qlen[:, None], n, nseq)[:, 0],
        want[::10])
    raw = rng.integers(-5, 120, (8192, 10))
    m_eff = np.maximum(m - want, 1.0 / k)
    n_eff = np.maximum(n - nseq * want, 1.0 / k)
    e_want = k * m_eff * n_eff * np.exp(-lam * raw.reshape(-1).astype(
        np.float64))
    for q in (qlen[:, None], np.repeat(qlen, 10).reshape(8192, 10)):
        e = tevalue.e_value(raw, q, n, lam, k, h=h, db_seqs=nseq)
        assert e.shape == (8192, 10)
        assert np.array_equal(e.reshape(-1), e_want)
