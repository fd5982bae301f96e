"""The port stands alone: no module under src/repro_torch/, and not
chip_smoke.py, imports jax or the JAX package `repro`; importing the port
leaves jax out of sys.modules; and importing a kernel module builds
nothing and needs neither nvcc nor triton (kernels compile at first
launch)."""
import ast
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_file_inventory():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for must in ("chip_smoke.py", "src/repro_torch/core/pipeline.py",
                 "src/repro_torch/kernels/radix_sort.py",
                 "src/repro_torch/kernels/reindex_epilogue.py",
                 "src/repro_torch/kernels/merge.py",
                 "src/repro_torch/kernels/set_count.py",
                 "src/repro_torch/kernels/segment_agg.py",
                 "src/repro_torch/kernels/ptr_scan.py",
                 "src/repro_torch/kernels/flash_attention.py",
                 "src/repro_torch/kernels/prefix_partition.py",
                 "src/repro_torch/models/common.py",
                 "src/repro_torch/models/attention.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/configs/gemma2_9b.py",
                 "src/repro_torch/launch/steps.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/train/optim.py",
                 "src/repro_torch/train/checkpoint.py",
                 "src/repro_torch/train/loop.py",
                 "src/repro_torch/data/synthetic.py",
                 "src/repro_torch/serve/gnn.py",
                 "src/repro_torch/serve/slots.py",
                 "src/repro_torch/serve/engine.py",
                 "src/repro_torch/serve/scheduler.py",
                 "src/repro_torch/kernels/decode_attention.py",
                 "src/repro_torch/serve/request.py",
                 "src/repro_torch/core/sampling.py",
                 "src/repro_torch/core/prng.py",
                 "src/repro_torch/models/gnn.py",
                 "src/repro_torch/configs/graphsage_reddit.py",
                 "src/repro_torch/configs/gat_cora.py",
                 "src/repro_torch/configs/gatedgcn.py",
                 "src/repro_torch/configs/meshgraphnet.py",
                 "src/repro_torch/core/costmodel.py",
                 "src/repro_torch/core/reconfig.py",
                 "src/repro_torch/core/delta.py",
                 "src/repro_torch/engine/__init__.py",
                 "src/repro_torch/engine/service.py",
                 "src/repro_torch/engine/prefetch.py",
                 "src/repro_torch/models/dlrm.py",
                 "src/repro_torch/configs/dlrm_rm2.py",
                 "src/repro_torch/train/compress.py",
                 "src/repro_torch/dist/__init__.py",
                 "src/repro_torch/dist/sharding.py",
                 "src/repro_torch/dist/hints.py",
                 "src/repro_torch/dist/groups.py",
                 "src/repro_torch/dist/collectives.py",
                 "src/repro_torch/engine/shard.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/analysis/__init__.py",
                 "src/repro_torch/analysis/__main__.py",
                 "src/repro_torch/analysis/census.py",
                 "src/repro_torch/analysis/contracts.py",
                 "src/repro_torch/analysis/checker.py",
                 "src/repro_torch/analysis/lint.py"):
        assert must in names, must


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    """Also with nvcc and triton unreachable: PATH holds only the
    interpreter's directory, CUDA_HOME points nowhere, and an import hook
    refuses triton."""
    code = (
        "import sys\n"
        "class _NoTriton:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'triton':\n"
        "            raise ImportError('triton is not reachable here')\n"
        "sys.meta_path.insert(0, _NoTriton())\n"
        "import repro_torch.core.pipeline, repro_torch.serve\n"
        "import repro_torch.kernels.radix_sort\n"
        "import repro_torch.kernels.reindex_epilogue\n"
        "import repro_torch.kernels.merge, repro_torch.kernels.set_count\n"
        "import repro_torch.kernels.segment_agg\n"
        "import repro_torch.kernels.ptr_scan\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.decode_attention\n"
        "import repro_torch.serve.engine\n"
        "import repro_torch.kernels.prefix_partition\n"
        "import repro_torch.models.transformer, repro_torch.launch.steps\n"
        "import repro_torch.launch.train, repro_torch.train.loop\n"
        "import repro_torch.engine, repro_torch.core.reconfig\n"
        "import repro_torch.core.delta, repro_torch.core.sampling\n"
        "import repro_torch.models.gnn, repro_torch.serve.slots\n"
        "import repro_torch.models.moe, repro_torch.configs.base\n"
        "import repro_torch.models.dlrm, repro_torch.train.compress\n"
        "import repro_torch.dist, repro_torch.dist.collectives\n"
        "import repro_torch.engine.shard, repro_torch.launch.mesh\n"
        "import repro_torch.launch.dryrun, repro_torch.analysis\n"
        "import repro_torch.analysis.census, repro_torch.analysis.checker\n"
        "import repro_torch.analysis.contracts\n"
        "import repro_torch.analysis.__main__\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "for a in ARCHS:\n"
        "    get_config(a), get_config(a, smoke=True)\n"
        "from repro_torch.kernels import _build, kernel_wrappers\n"
        "assert len(kernel_wrappers()) == 19\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "assert not _build._LIBS\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "PATH": os.path.dirname(sys.executable),
           "CUDA_HOME": os.path.join(ROOT, "no-such-cuda")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_build_list_follows_csrc():
    """Every csrc/*.cu is in the build list, sorted, and nothing else."""
    from repro_torch.kernels import _build
    cu = sorted(f[:-3] for f in os.listdir(os.path.join(PORT, "csrc"))
                if f.endswith(".cu"))
    assert list(_build.SOURCES) == cu
    assert {"digit_pass", "flash_attention", "flash_attention_bwd", "merge",
            "prefix_partition", "reindex_epilogue", "segment_agg",
            "set_count"} <= set(cu)


def test_library_hash_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/*.cuh (the flash
    kernels' shared flash_mma.cuh), so editing a header rebuilds each
    source that may include it, and an unchanged tree reuses the build."""
    from repro_torch.kernels import _build
    for f in ("a.cu", "b.cu", "common.cuh"):
        (tmp_path / f).write_text(f"// {f}\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = {n: _build.library_path(n) for n in ("a", "b")}
    assert before == {n: _build.library_path(n) for n in ("a", "b")}
    (tmp_path / "common.cuh").write_text("// edited\n")
    after = {n: _build.library_path(n) for n in ("a", "b")}
    assert all(after[n] != before[n] for n in ("a", "b"))
    assert os.path.exists(os.path.join(PORT, "csrc", "flash_mma.cuh"))
