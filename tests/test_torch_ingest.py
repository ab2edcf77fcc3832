"""PyTorch port: bag ingest (the bag writer and readers, LZ4 frames, the
builder, the native reader, the ingest cache) against the JAX package."""

import shutil
from pathlib import Path

import numpy as np
import pytest

from nautilus_tpu.core.luaconf import load_config_text as jax_config
from nautilus_tpu.ingest import builder as jbuilder
from nautilus_tpu.ingest import lz4f as jlz4f
from nautilus_tpu.ingest import native as jnative
from nautilus_tpu.ingest import rosbag as jrb
from nautilus_tpu.ingest.synthetic import write_synthetic_bag as jax_bag
from nautilus_tpu_torch.core.luaconf import load_config_text
from nautilus_tpu_torch.ingest import builder as tbuilder
from nautilus_tpu_torch.ingest import cache as tcache
from nautilus_tpu_torch.ingest import lz4f as tlz4f
from nautilus_tpu_torch.ingest import native as tnative
from nautilus_tpu_torch.ingest import rosbag as trb
from nautilus_tpu_torch.ingest.synthetic import write_synthetic_bag

FIXTURES = Path(__file__).resolve().parent / "fixtures"
COMPRESSIONS = ["none", "bz2", "lz4"]
CFG = """
pose_number={n}
differential_odom={diff}
max_lidar_range=30
rotation_change_for_lidar=math.pi / 18
translation_change_for_lidar=0.25
lidar_topic="/scan"
odom_topic="{odom}"
"""

needs_libbz2 = pytest.mark.skipif(tnative.library_path() is None,
                                  reason="the system libbz2 is absent")


def _messages(rb, seed=0, count=40):
    """Random (topic, time, msg) tuples of the three decoded types and an
    unwanted topic, built from ``rb``'s message classes, times unsorted."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(count):
        t = 1e9 + float(rng.uniform(0, 20))
        kind = k % 4
        if kind == 0:
            out.append(("/scan", t, rb.LaserScanMsg(
                rb.HeaderMsg(k, t, "laser"),
                angle_min=float(rng.uniform(-np.pi, 0)),
                angle_max=float(rng.uniform(0, np.pi)),
                angle_increment=float(rng.uniform(0.001, 0.1)),
                time_increment=0.0, scan_time=0.05, range_min=0.02,
                range_max=30.0,
                ranges=rng.uniform(0.1, 30, int(rng.integers(3, 300)))
                .astype(np.float32),
                intensities=np.zeros(0, np.float32))))
        elif kind == 1:
            q = rng.normal(size=4)
            out.append(("/odom", t, rb.OdometryMsg(
                rb.HeaderMsg(k, t, "odom"), "base", position=rng.normal(size=3),
                orientation=q / np.linalg.norm(q),
                twist_linear=rng.normal(size=3),
                twist_angular=rng.normal(size=3))))
        elif kind == 2:
            out.append(("/cobot", t, rb.CobotOdometryMsg(
                rb.HeaderMsg(k, t, "odom"), dr=float(rng.normal()),
                dx=float(rng.normal()), dy=float(rng.normal()))))
        else:
            out.append(("/junk", t, rb.OdometryMsg(
                rb.HeaderMsg(k, t, "odom"), "x", position=np.zeros(3),
                orientation=np.array([0.0, 0.0, 0.0, 1.0]),
                twist_linear=np.zeros(3), twist_angular=np.zeros(3))))
    return out


def _assert_same_stream(a, b, exact_time=True):
    """Two decoded message streams carry the same messages in order."""
    assert len(a) == len(b) > 0
    for ma, mb in zip(a, b):
        assert ma.topic == mb.topic
        assert type(ma.msg).__name__ == type(mb.msg).__name__
        if exact_time:
            assert ma.time == mb.time
        else:
            assert ma.time == pytest.approx(mb.time, abs=1e-6)
        m, n = ma.msg, mb.msg
        if hasattr(m, "ranges"):
            np.testing.assert_array_equal(m.ranges, n.ranges)
            assert (m.angle_min, m.angle_max, m.angle_increment,
                    m.range_min, m.range_max) == (
                n.angle_min, n.angle_max, n.angle_increment, n.range_min,
                n.range_max)
        elif hasattr(m, "position"):
            np.testing.assert_array_equal(m.position, n.position)
            np.testing.assert_array_equal(m.orientation, n.orientation)
        else:
            assert (m.dr, m.dx, m.dy) == (n.dr, n.dx, n.dy)


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_writer_bytes_match_jax(tmp_path, compression):
    trb.write_bag(tmp_path / "t.bag", _messages(trb), compression=compression)
    jrb.write_bag(tmp_path / "j.bag", _messages(jrb), compression=compression)
    assert (tmp_path / "t.bag").read_bytes() == \
        (tmp_path / "j.bag").read_bytes()


@pytest.mark.parametrize("differential", [False, True])
def test_synthetic_bag_bytes_match_jax(tmp_path, differential):
    kw = dict(num_nodes=12, world_kind="room", num_beams=180, seed=7,
              differential=differential, substeps=2)
    write_synthetic_bag(tmp_path / "t.bag", **kw)
    jax_bag(tmp_path / "j.bag", **kw)
    assert (tmp_path / "t.bag").read_bytes() == \
        (tmp_path / "j.bag").read_bytes()


@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_packages_read_each_others_bags(tmp_path, compression):
    trb.write_bag(tmp_path / "t.bag", _messages(trb, 1), compression=compression)
    jrb.write_bag(tmp_path / "j.bag", _messages(jrb, 1), compression=compression)
    topics = ["/scan", "/odom", "/cobot"]
    from_jax_bag = list(trb.read_bag(tmp_path / "j.bag", topics=topics))
    from_port_bag = list(jrb.read_bag(tmp_path / "t.bag", topics=topics))
    _assert_same_stream(from_jax_bag, from_port_bag)
    _assert_same_stream(from_jax_bag,
                        list(jrb.read_bag(tmp_path / "j.bag", topics=topics)))
    times = [m.time for m in from_jax_bag]
    assert times == sorted(times)
    assert {m.topic for m in from_jax_bag} == set(topics)


def test_xxh32_vectors():
    # Published xxHash32 values, seed 0.
    assert tlz4f.xxh32(b"") == 0x02CC5D05
    assert tlz4f.xxh32(b"abc") == 0x32D153FF
    rng = np.random.default_rng(0)
    for n in (1, 3, 4, 15, 16, 17, 31, 64, 257):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 1, 0x9E3779B1):
            assert tlz4f.xxh32(data, seed) == jlz4f.xxh32(data, seed)


def test_lz4_frame_roundtrip():
    rng = np.random.default_rng(1)
    # Compressible text, then incompressible noise: several 64 KB blocks,
    # some stored raw.
    data = (b"nautilus " * 20000) + rng.integers(0, 256, 150_000,
                                                dtype=np.uint8).tobytes()
    frame = tlz4f.compress(data)
    assert frame == jlz4f.compress(data)
    assert tlz4f.decompress(frame) == data
    assert jlz4f.decompress(frame) == data
    assert tlz4f.decompress(tlz4f.compress(b"")) == b""
    with pytest.raises(ValueError, match="magic"):
        tlz4f.decompress(b"\x00" * 16)


def _bag_case(tmp_path, case):
    """(bag path, config text) of a builder case."""
    if case == "shuffled":
        return FIXTURES / "shuffled_chunks.bag", CFG.format(
            n=10, diff="false", odom="/odom")
    diff = case == "differential"
    bag = tmp_path / f"{case}.bag"
    write_synthetic_bag(bag, num_nodes=40, world_kind="office", num_beams=360, seed=4,
            substeps=2, differential=diff, odom_noise_trans=0.01,
            odom_noise_rot=0.004)
    return bag, CFG.format(n=40, diff=str(diff).lower(), odom="/odom")


@pytest.mark.parametrize("reader", ["native", "python"])
@pytest.mark.parametrize("case", ["absolute", "differential", "shuffled"])
def test_process_bag_file_bitwise_equal_to_jax(tmp_path, monkeypatch, case,
                                               reader):
    bag, text = _bag_case(tmp_path, case)
    want = jbuilder.process_bag_file(bag, jax_config(text), verbose=False)
    if reader == "python":
        monkeypatch.setattr(tnative, "read_bag_native", lambda *a: None)
    got = tbuilder.process_bag_file(bag, load_config_text(text),
                                    verbose=False)
    assert got._fields == want._fields
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    if case != "shuffled":
        assert 20 <= got.points.shape[0] <= 40


@needs_libbz2
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_native_reader_matches_python_and_jax(tmp_path, compression):
    bag = tmp_path / "b.bag"
    trb.write_bag(bag, _messages(trb, 2, count=60), compression=compression)
    native = tnative.read_bag_native(bag, "/scan", "/odom")
    python = list(trb.read_bag(bag, topics=["/scan", "/odom"]))
    _assert_same_stream(native, python, exact_time=False)
    if jnative.available():
        _assert_same_stream(native, jnative.read_bag_native(bag, "/scan",
                                                            "/odom"))
    cobots = tnative.read_bag_native(bag, "/scan", "/cobot")
    _assert_same_stream(cobots, list(trb.read_bag(
        bag, topics=["/scan", "/cobot"])), exact_time=False)


@needs_libbz2
def test_native_reader_reports_parse_errors(tmp_path):
    bad = tmp_path / "bad.bag"
    bad.write_bytes(b"garbage")
    with pytest.raises(ValueError, match="not a ROS bag"):
        tnative.read_bag_native(bad, "/scan", "/odom")


def test_python_reader_only_without_libbz2(tmp_path, monkeypatch, capsys):
    """Without libbz2 the Python reader runs and says so; with it, a build
    that fails raises instead of falling back."""
    bag, text = _bag_case(tmp_path, "shuffled")
    monkeypatch.setattr(tnative, "_lib", None)
    real_find = tnative._find_shared
    monkeypatch.setattr(tnative, "_find_shared",
                        lambda name: None if name == "bz2" else real_find(name))
    assert tnative.reader_name() == "python"
    tbuilder.process_bag_file(bag, load_config_text(text))
    assert "(Python bag reader: the system libbz2 is absent" in \
        capsys.readouterr().out
    if real_find("bz2") is None:
        return
    monkeypatch.setattr(tnative, "_find_shared", real_find)
    broken = tmp_path / "bagreader.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tbuilder.process_bag_file(bag, load_config_text(text))


def test_ingest_cache_hit_and_miss(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    cdir = tcache.cache_dir()
    assert cdir == tmp_path / ".cache" / "nautilus_tpu_torch" / "ingest"
    bag = tmp_path / "c.bag"
    shutil.copy(FIXTURES / "shuffled_chunks.bag", bag)
    cfg = load_config_text(CFG.format(n=10, diff="false", odom="/odom"))
    first = tcache.load_or_ingest(bag, cfg, verbose=False)
    assert len(list(cdir.glob("*.npz"))) == 1
    hit = tcache.load_or_ingest(bag, cfg, verbose=True)
    assert "(ingest cache hit:" in capsys.readouterr().out
    for name in first._fields:
        np.testing.assert_array_equal(getattr(hit, name), getattr(first, name))
    # A changed ingest key misses and adds a second entry.
    fewer = cfg.replace(pose_number=3)
    assert tcache.cache_path(bag, fewer) != tcache.cache_path(bag, cfg)
    third = tcache.load_or_ingest(bag, fewer, verbose=True)
    assert "cache hit" not in capsys.readouterr().out
    assert third.points.shape[0] == 3
    assert len(list(cdir.glob("*.npz"))) == 2
