"""The port's native .key I/O (``sift3d_torch.io.native``, the C++ writer and
reader of ``csrc/key_text.cpp``, built with g++ at first use) against its
plain version (``keyfile`` with ``use_native=False``) and the JAX package's
two routes (``sift3d.io.keyfile``: its native library and its Python
writer and reader), and the binary variant against the JAX package's.

Bytes: port native = port plain = JAX native on every row below, the JAX
Python writer too except where it drops a NaN's sign (glibc prints "-nan",
Python's "%f" prints "nan"; ROADMAP Queue 3 classifies it). Descriptor
values beyond the int64 range (1e20, inf, NaN) are undefined in C and in
numpy; on x86-64 every writer prints 0 for them (the conversion gives
INT64_MIN, whose low byte is 0), and the test pins that.

Reads: port native = port plain = JAX ``read_text`` (its native route, the
JAX CLI's): arrays, comments, the declared-count truncation and a file cut
inside a row (the rows before it; the JAX Python reader raises there
instead). Each decimal rounds to f32 once, as strtof does; a constructed
decimal just above an f32 midpoint pins that (the JAX Python reader parses
to f64 first and rounds it to the even neighbour).
"""

import threading

import numpy as np
import pytest

from sift3d.core.featureset import FeatureSet as JxFeatureSet
from sift3d.io import keyfile as jx_keyfile
from sift3d_torch.core.featureset import FeatureSet
from sift3d_torch.io import keyfile, native
from sift3d_torch.pipeline.extract import extract_features

from test_torch_extract_48 import _noisy_blob_fixtures

FIELDS = ("xyz", "scale", "ori", "eigs", "info", "desc")
COMMENTS = ["Extraction Voxel Resolution (ijk) : 48 48 48", "a comment"]


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return FeatureSet(
        xyz=rng.uniform(0, 200, (n, 3)).astype(np.float32),
        scale=rng.uniform(1, 20, n).astype(np.float32),
        ori=rng.standard_normal((n, 3, 3)).astype(np.float32),
        eigs=rng.uniform(0, 100, (n, 3)).astype(np.float32),
        info=rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
        desc=rng.integers(0, 64, (n, 64)).astype(np.float32),
    )


def _with(feats, **fields):
    d = {k: getattr(feats, k).copy() for k in FIELDS}
    d.update(fields)
    return FeatureSet(**d)


def _float_rows(values):
    """One row per 16 values: the values as x, y, z, scale, ori, eigs."""
    v = np.asarray(values, np.float32).reshape(-1, 16)
    f = _rows(len(v), seed=1)
    return _with(f, xyz=v[:, 0:3].copy(), scale=v[:, 3].copy(), ori=v[:, 4:13].reshape(-1, 3, 3).copy(),
                 eigs=v[:, 13:16].copy())


def _pad16(values):
    v = list(values)
    return v + [0.5] * (-len(v) % 16)


def _edge_ties():
    # odd multiples of 2^-7 end in a 5 at the 7th decimal: "%f" rounds them
    # half to even; and values next to decimal ties of larger magnitude
    j = np.arange(1, 2 * 256, 2)
    v = np.concatenate([j / 128.0, -j / 128.0, j / 128.0 + 1000.0])
    near = np.float32(0.0000005)
    return _pad16(np.concatenate([v, [near, np.nextafter(near, 1), np.nextafter(near, 0), 2.5e-7, 999999.9999995]]))


def _edge_random_bits():
    # every finite f32 exponent, both signs: the fast "%f" path below 1e12
    # and snprintf above it
    bits = np.random.default_rng(2).integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    v = bits.view(np.float32)
    return _pad16(v[np.isfinite(v)])


EDGE_ROWS = {
    "inf": lambda: _float_rows(_pad16([np.inf, -np.inf, 1.0, -np.inf])),
    "nan": lambda: _float_rows(_pad16([np.nan, 2.0, np.nan])),
    "-nan": lambda: _float_rows(_pad16([-np.nan, 3.0, -np.nan, np.nan])),
    "-0": lambda: _float_rows(_pad16([-0.0, 0.0, -0.0])),
    "small negatives": lambda: _float_rows(_pad16([-1e-7, -4.9e-7, -5e-7, -5.1e-7, -1e-30, -1e-45, 4e-7])),
    "ties": lambda: _float_rows(_edge_ties()),
    "random bits": lambda: _float_rows(_edge_random_bits()),
    "longest": lambda: _with(_float_rows([-3.4028235e38] * 16), info=np.array([2**32 - 1], np.uint32),
                             desc=np.full((1, 64), -128.0, np.float32)),
    "descriptor wrap": lambda: _with(_rows(1), desc=np.resize(
        np.array([-129, -1.5, 127.9, 128, 255, 256, 1e10, -1e10, 0.99, -0.99], np.float32), (1, 64))),
    "descriptor beyond int64": lambda: _with(_rows(1), desc=np.resize(
        np.array([1e20, -1e20, np.inf, -np.inf, np.nan, 5.0], np.float32), (1, 64))),
}


def _jx(feats):
    return JxFeatureSet(**{k: getattr(feats, k) for k in FIELDS})


def _write_all(feats, d, eig_threshold=-1.0, comments=COMMENTS):
    """Write with the four writers; returns their bytes by name."""
    writers = {
        "port native": lambda p: keyfile.write_text(feats, p, eig_threshold, comments),
        "port plain": lambda p: keyfile.write_text(feats, p, eig_threshold, comments, use_native=False),
        "jax native": lambda p: jx_keyfile.write_text(_jx(feats), p, eig_threshold, comments),
        "jax python": lambda p: jx_keyfile.write_text(_jx(feats), p, eig_threshold, comments, use_native=False),
    }
    out, counts = {}, set()
    with np.errstate(invalid="ignore"):
        for name, write in writers.items():
            path = d / (name.replace(" ", "_") + ".key")
            counts.add(write(str(path)))
            out[name] = path.read_bytes()
    assert len(counts) == 1
    return out


def _assert_same(a: FeatureSet, b):
    assert len(a) == len(b)
    for k in FIELDS:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.shape == y.shape and x.dtype == y.dtype, k
        np.testing.assert_array_equal(x.view(np.uint32) if x.dtype == np.float32 else x,
                                      y.view(np.uint32) if y.dtype == np.float32 else y, err_msg=k)


def _read_all(path, eig_threshold=-1.0):
    """Port native, port plain and JAX read_text (native) of one file."""
    port = keyfile.read_text(str(path), eig_threshold)
    plain = keyfile.read_text(str(path), eig_threshold, use_native=False)
    jax = jx_keyfile.read_text(str(path), eig_threshold)
    assert port[1] == plain[1] == jax[1]
    _assert_same(port[0], plain[0])
    _assert_same(port[0], jax[0])
    return port


@pytest.fixture(scope="module")
def extraction():
    """test_torch_extract_48.py's noisy two-blob 48^3 cell (171 rows)."""
    return extract_features(_noisy_blob_fixtures()["blob48_a"], device="cpu")


@pytest.mark.parametrize("eig_threshold", [-1.0, 140.0])
def test_extraction_bytes_and_reads(extraction, eig_threshold, tmp_path):
    out = _write_all(extraction, tmp_path, eig_threshold)
    assert len(set(out.values())) == 1, [k for k in out if out[k] != out["jax native"]]
    kept = extraction.eig_mask(eig_threshold).sum()
    assert 0 < kept <= len(extraction)
    feats, comments = _read_all(tmp_path / "port_native.key")
    assert comments == ["featExtract 1.1", *COMMENTS] and len(feats) == kept
    _read_all(tmp_path / "port_native.key", eig_threshold=140.0)


@pytest.mark.parametrize("case", sorted(EDGE_ROWS))
def test_edge_rows(case, tmp_path):
    feats = EDGE_ROWS[case]()
    out = _write_all(feats, tmp_path)
    assert out["port native"] == out["jax native"]
    assert out["port plain"] == out["jax native"]
    if case == "-nan":  # the JAX Python writer drops the sign (Queue 3)
        assert out["jax python"] == out["jax native"].replace(b"-nan", b"nan") != out["jax native"]
    else:
        assert out["jax python"] == out["jax native"]
    rows = out["port native"].decode().splitlines()[3 + len(COMMENTS):]
    assert len(rows) == len(feats)
    if case == "longest":
        assert len(rows[0]) + 1 == 16 * 48 + 11 + 64 * 5 + 1 <= 4096
    if case in ("descriptor wrap", "descriptor beyond int64"):
        desc = [int(t) for t in rows[0].split("\t")[17:81]]
        want = {"descriptor wrap": [127, -1, 127, -128, -1, 0, 0, 0, 0, 0],
                "descriptor beyond int64": [0, 0, 0, 0, 0, 5]}[case]
        assert desc == list(np.resize(want, 64))
    _read_all(tmp_path / "port_native.key")


def test_eig_filter_keeps_the_rows_featureset_keeps(tmp_path):
    """The write-time filter (built with -ffp-contract=off) against
    FeatureSet.eig_mask on eigenvalues spread around the threshold."""
    rng = np.random.default_rng(3)
    f = _rows(20000, seed=3)
    f.eigs = (rng.uniform(0.5, 1.5, (20000, 3)) * rng.uniform(0.001, 1, (20000, 1)) ** [0, 1, 2]).astype(np.float32)
    mask = f.eig_mask(140.0)
    assert 0.05 < mask.mean() < 0.95
    assert keyfile.write_text(f, str(tmp_path / "a.key"), 140.0) == mask.sum()
    got, _ = keyfile.read_text(str(tmp_path / "a.key"))
    np.testing.assert_array_equal(got.info, f.info[mask])


def test_strtof_rounds_once(tmp_path):
    """1 + 2^-24 is halfway between 1 and the next f32; a decimal just above
    it parses to exactly that midpoint in f64, which then rounds to the even
    1.0, while strtof rounds the decimal once, up."""
    f = _rows(2)
    path = tmp_path / "mid.key"
    keyfile.write_text(f, str(path))
    lines = path.read_text().splitlines()
    fields = lines[3].split("\t")  # the first row, after version, count and legend
    fields[0] = "1.0000000596046447753906250000001"
    fields[1] = "1.0000000596046447753906249999999"
    fields[2] = "1.000000059604644775390625"  # the midpoint itself: to even
    lines[3] = "\t".join(fields)
    path.write_text("\n".join(lines) + "\n")
    feats, _ = _read_all(path)
    up = np.nextafter(np.float32(1.0), np.float32(2.0))
    np.testing.assert_array_equal(feats.xyz[0], np.array([up, 1.0, 1.0], np.float32))
    py, _ = jx_keyfile.read_text(str(path), use_native=False)
    assert py.xyz[0, 0] == np.float32(1.0)  # two roundings


def _text_file(tmp_path, text):
    path = tmp_path / "k.key"
    path.write_text(text)
    return path


LEGEND = keyfile.LEGEND_LINE + "\n"


@pytest.mark.parametrize("text", ["", "# featExtract 1.1\n", "# featExtract 1.1\nFeatures: 3\n",
                                  "# featExtract 1.1\nFeatures: 3\nnot the legend\n", "Features: x\n" + LEGEND])
def test_malformed_headers_raise_as_jax(tmp_path, text):
    path = _text_file(tmp_path, text)
    for read in (lambda p: keyfile.read_text(p), lambda p: keyfile.read_text(p, use_native=False),
                 lambda p: jx_keyfile.read_text(p)):
        with pytest.raises(ValueError):
            read(str(path))


def test_truncated_and_short_files(tmp_path):
    f = _rows(6, seed=4)
    src = tmp_path / "full.key"
    keyfile.write_text(f, str(src))
    lines = src.read_text().splitlines(keepends=True)
    head, rows = lines[:3], lines[3:]  # version, count, legend
    cases = {
        "empty body": (["# featExtract 1.1\n", "Features: 0\n", LEGEND], 0),
        "fewer rows than declared": (head + rows[:3], 3),
        "cut inside a row": (head + rows[:4] + [rows[4][:300]], 4),
        "a row one descriptor short": (head + rows[:2] + [rows[2].rstrip("\t\n").rsplit("\t", 1)[0] + "\n"] + rows[3:], 2),
        "a blank line": (head + rows[:2] + ["\n"] + rows[2:], 2),
        "more rows than declared": ([head[0], "Features: 2\n", head[2]] + rows, 2),
    }
    for name, (lines, n) in cases.items():
        path = _text_file(tmp_path, "".join(lines))
        feats, _ = _read_all(path)
        assert len(feats) == n, name
        if n:
            np.testing.assert_array_equal(feats.info, f.info[: n], err_msg=name)


def test_binary_bytes_and_round_trip(extraction, tmp_path):
    for feats in (extraction, EDGE_ROWS["random bits"](), EDGE_ROWS["-nan"](), EDGE_ROWS["inf"]()):
        for thr in (-1.0, 140.0):
            n = keyfile.write_binary(feats, str(tmp_path / "port.bin"), thr)
            assert n == jx_keyfile.write_binary(_jx(feats), str(tmp_path / "jax.bin"), thr)
            data = (tmp_path / "port.bin").read_bytes()
            assert data == (tmp_path / "jax.bin").read_bytes()
            assert data.startswith(b"# featExtract 1.1\nFeatures: %d\n" % n)
            assert len(data) == len(b"# featExtract 1.1\nFeatures: %d\n" % n) + n * (16 * 4 + 4 + 64)
            got = keyfile.read_binary(str(tmp_path / "port.bin"))
            _assert_same(got, jx_keyfile.read_binary(str(tmp_path / "port.bin")))
            _assert_same(got, feats.select(feats.eig_mask(thr)))


def test_library_loads_once_from_many_threads(tmp_path, monkeypatch):
    """Eight threads load the library at once: one build, one handle; then
    each writes and reads its own file at the same time, with the bytes of a
    write alone."""
    f = _rows(500, seed=5)
    keyfile.write_text(f, str(tmp_path / "plain.key"), comments=COMMENTS, use_native=False)
    want = (tmp_path / "plain.key").read_bytes()
    want_rows = keyfile.read_text(str(tmp_path / "plain.key"), use_native=False)[0]
    builds = []
    build = native.build

    def counted():
        builds.append(1)
        return build()

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "build", counted)
    barrier = threading.Barrier(8)
    libs, errors = [], []

    def work(i):
        try:
            barrier.wait()
            libs.append(native.load())
            path = tmp_path / f"t{i}.key"
            keyfile.write_text(f, str(path), comments=COMMENTS)
            assert path.read_bytes() == want
            _assert_same(keyfile.read_text(str(path))[0], want_rows)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(builds) == 1 and len({id(lib) for lib in libs}) == 1


def test_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "key_text.cpp"
    bad.write_text('extern "C" int s3d_key_count(const char *p) { return undeclared_name; }\n')
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.load()


def test_decimal_shortcut_rounds_as_strtof(tmp_path):
    """The native reader's shortcut for short decimals ([+-]digits[.digits],
    at most 15 digits, 6 after the point) against strtof (the JAX native
    reader) and the plain reader, on random such tokens of every length and
    on tokens just past the shortcut (7 decimals, 16 digits, exponents)."""
    rng = np.random.default_rng(6)
    toks = []
    for _ in range(81 * 200):
        frac = int(rng.integers(0, 9))
        digits = int(rng.integers(max(frac, 1), 17))
        s = "".join(rng.choice(list("0123456789"), digits))
        s = s[: digits - frac] + ("." + s[digits - frac:] if frac else rng.choice(["", "."]))
        toks.append(rng.choice(["", "-", "+"]) + (s if not s.startswith(".") else "0" + s))
    past = ["1e3", "-2.5E-3", "0x1p-3", "16777217.5", "0.00000005", "+.5", "5.", "-0", "1234567890123456"]
    toks[::97] = [past[i % len(past)] for i in range(len(toks[::97]))]
    rows = []
    for r in range(200):
        t = toks[81 * r: 81 * (r + 1)]
        rows.append("\t".join(t[:16] + [str(r)] + t[17:]) + "\t\n")
    path = _text_file(tmp_path, "# featExtract 1.1\nFeatures: 200\n" + LEGEND + "".join(rows))
    feats, _ = _read_all(path)
    assert len(feats) == 200


@pytest.mark.parametrize("case", ["random", "edges"])
def test_match_file_native_is_the_plain_bytes(case, tmp_path):
    """featmatch's match files through the native writer (io/native.py,
    s3d_write_match_text) and formatted in Python: the same bytes, match
    numbers and rows past the zero-padded widths and a name holding a %."""
    from sift3d_torch.cli import featmatch

    f = _rows(3000, seed=7) if case == "random" else EDGE_ROWS["ties"]()
    if case == "edges":
        f = FeatureSet.concatenate([f, EDGE_ROWS["-0"](), EDGE_ROWS["small negatives"](), EDGE_ROWS["random bits"](),
                                    EDGE_ROWS["-nan"](), EDGE_ROWS["inf"]()])
    n = len(f)
    rows = np.random.default_rng(8).permutation(n)[: min(n, 12000)]
    other = np.random.default_rng(9).integers(0, 3_000_000, len(rows))
    header = "# Img1: a%d.key\n# Img2: b.key\n# Matches: %d\n# Format: Img1 x1 y1 z1 s1 MatchIndexImg2 DistSqr\n" % (
        0, len(rows))
    out = {}
    for route in (True, False):
        path = tmp_path / f"{route}.txt"
        featmatch.write_match_file(str(path), header, "img%s.key", f, rows, other, use_native=route)
        out[route] = path.read_bytes()
    if case == "edges":  # Python's "%f", the JAX CLI's, drops a NaN's sign; so does the native writer here
        assert b"-nan" not in out[False] and b"nan" in out[False]
    assert out[True] == out[False]
