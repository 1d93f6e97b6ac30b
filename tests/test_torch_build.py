"""The build of the port's kernels (rumpy_tpu_torch.ops.cuda.build) under
concurrent first use, with a stand-in for nvcc: a data loader's worker
threads may all reach a kernel's first launch at once."""

import stat
import sys
import threading

import pytest

from rumpy_tpu_torch.ops.cuda import build


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """csrc/ with two sources and a header, and an 'nvcc' that takes a
    moment, logs its call and writes its output file."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "a.cu").write_text("// a\n")
    (csrc / "b.cu").write_text("// b\n")
    (csrc / "common.cuh").write_text("// shared\n")
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "time.sleep(0.2)\n"
        f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "_locks", {})
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: ("loaded", path))
    return csrc, out, log


def test_concurrent_first_use_builds_each_library_once(fake_toolchain):
    csrc, out, log = fake_toolchain
    results, errors = [], []

    def worker(name):
        try:
            results.append((name, build.load(name)))
        except Exception as e:  # reported below: the test must not hang
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(name,))
               for name in ["a", "b"] * 8]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(results) == 16
    assert len({r for n, r in results if n == "a"}) == 1
    calls = log.read_text().split()
    assert sorted(calls) == [str(csrc / "a.cu"), str(csrc / "b.cu")]
    assert sorted(p.name[:4] for p in out.iterdir()) == ["liba", "libb"]


def test_load_all_and_rebuild_on_a_changed_header(fake_toolchain):
    csrc, out, log = fake_toolchain
    build.build_all(["a", "b"])
    first = {p.name for p in out.iterdir()}
    assert len(first) == 2 and len(log.read_text().split()) == 2
    build.build_all(["a", "b"])  # built already: nothing runs
    build.load("a")
    assert len(log.read_text().split()) == 2
    # a header is part of every library's name: editing it rebuilds both
    (csrc / "common.cuh").write_text("// shared, edited\n")
    build.build_all(["a", "b"])
    assert len(log.read_text().split()) == 4
    assert len({p.name for p in out.iterdir()} - first) == 2


def test_bind_runs_once_before_the_library_is_handed_out(fake_toolchain):
    bound, results = [], []

    def bind(lib):
        bound.append(lib)

    threads = [threading.Thread(target=lambda: results.append(build.load("a", bind)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 8 and len(bound) == 1
    assert all(r is bound[0] for r in results)


def test_a_failed_build_raises_with_the_compiler_output(fake_toolchain, tmp_path,
                                                        monkeypatch):
    bad = tmp_path / "bad_nvcc"
    bad.write_text(f"#!{sys.executable}\nimport sys\n"
                   "print('error: no such thing', file=sys.stderr)\nsys.exit(1)\n")
    bad.chmod(bad.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(build, "_nvcc", lambda: str(bad))
    with pytest.raises(RuntimeError, match="no such thing"):
        build.load("a")
    assert "a" not in build._libs
