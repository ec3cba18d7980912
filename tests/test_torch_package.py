"""Package-level properties of the PyTorch port: jax-free imports, a bridge
that fails loudly, and kernel wrappers that never fall back."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from open_genie_tpu_torch.bridge import load_flax_params  # noqa: E402
from open_genie_tpu_torch.modules.video import CausalConv3d  # noqa: E402
from open_genie_tpu_torch.ops.kernels.flash_attention import flash_attention  # noqa: E402
from open_genie_tpu_torch.ops.kernels.lfq_head import lfq_head  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'open_genie_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import open_genie_tpu_torch.models.genie\n"
        "import open_genie_tpu_torch.models.action\n"
        "import open_genie_tpu_torch.models.configs\n"
        "import open_genie_tpu_torch.bridge\n"
        "import open_genie_tpu_torch.ops.kernels.flash_attention\n"
        "import open_genie_tpu_torch.ops.kernels.lfq_head\n"
        "import open_genie_tpu_torch.ops.kernels.lfq_entropy\n"
        "import open_genie_tpu_torch.train.losses\n"
        "import open_genie_tpu_torch.train.loop\n"
        "import open_genie_tpu_torch.serve\n"
        "import open_genie_tpu_torch.eval\n"
        "import open_genie_tpu_torch.train.trainer\n"
        "import open_genie_tpu_torch.cli\n"
        "import open_genie_tpu_torch.data.native\n"
        "import open_genie_tpu_torch.data.kinetics\n"
        "import open_genie_tpu_torch.utils.debug\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_file_of_the_port_imports_jax():
    """Every module of the package, and `chip_smoke.py`, by their import
    statements: none names jax, flax or the JAX package."""
    import ast
    from pathlib import Path

    files = sorted(Path(REPO, "open_genie_tpu_torch").rglob("*.py"))
    files.append(Path(REPO, "chip_smoke.py"))
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "open_genie_tpu"), (
                    f"{path.relative_to(REPO)} imports {name}")


def _conv_params():
    return {"conv3d": {"kernel": np.zeros((3, 3, 3, 2, 4), np.float32),
                       "bias": np.zeros((4,), np.float32)}}


def test_bridge_loads_and_fails_loudly():
    conv = CausalConv3d(2, 4)
    params = _conv_params()
    params["conv3d"]["kernel"][0, 1, 2, 1, 3] = 1.0
    assert load_flax_params(conv, params) == []
    assert conv.conv3d.weight[3, 1, 0, 1, 2] == 1.0  # (kt,kh,kw,I,O)->(O,I,kt,kh,kw)

    missing = _conv_params()
    del missing["conv3d"]["bias"]
    with pytest.raises(KeyError, match="missing"):
        load_flax_params(conv, missing)
    unused = _conv_params()
    unused["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        load_flax_params(conv, unused)
    partial_qkv = {"to_q": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="to_q, to_k and to_v"):
        load_flax_params(conv, partial_qkv)


def test_wrappers_raise_instead_of_falling_back():
    """A tensor on a device without the kernel raises; so does any input
    the kernel does not take, on every device."""
    q = torch.empty(2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(q, q, q, 0.25)
    x, w, b = (torch.empty(*s, device="meta") for s in ((8, 4), (4, 3), (3,)))
    with pytest.raises(ValueError, match="no kernel for device"):
        lfq_head(x, w, b)

    bad = [
        (torch.zeros(2, 8, 8), "head dim"),
        (torch.zeros(2, 8, 16, dtype=torch.float16), "float32 or bfloat16"),
        (torch.zeros(2, 16, 8).transpose(1, 2), "contiguous"),
    ]
    for t, msg in bad:
        with pytest.raises(ValueError, match=msg):
            flash_attention(t, t, t, 0.25)
    with pytest.raises(ValueError, match="31 bits"):
        lfq_head(torch.zeros(8, 4), torch.zeros(4, 32), torch.zeros(32))
    with pytest.raises(ValueError, match="contiguous"):
        lfq_head(torch.zeros(4, 8).t(), torch.zeros(4, 3), torch.zeros(3))


def test_build_compiles_each_source_apart_then_links(tmp_path, monkeypatch):
    """One nvcc per source, then one link; the library lands under the
    hash of sources, headers and flags and is reused, with its build's
    report."""
    from open_genie_tpu_torch.ops import kernels

    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        open(args[args.index("-o") + 1], "w").write("x")
        with open({str(log)!r}, "a") as f:
            f.write(" ".join(a.rsplit("/", 1)[-1] for a in args) + "\\n")
    """))
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path / "build")
    out = kernels._build()
    assert out.exists() and out.parent.parent == tmp_path / "build" and kernels.BUILD["built"]
    calls = log.read_text().splitlines()
    compiles, links = calls[:-1], calls[-1]
    assert sorted(c.split(" -c ")[1].split()[0] for c in compiles) == [
        s.name for s in kernels.sources()]
    assert all("-gencode arch=compute_90a,code=sm_90a" in c for c in compiles)
    assert links.startswith("-shared") and links.count(".o") == len(kernels.sources())
    built_log = kernels.BUILD["log"]
    kernels.BUILD["log"] = ""
    assert kernels._build() == out and not kernels.BUILD["built"]  # reused
    assert kernels.BUILD["log"] == built_log  # with the build's report


def test_ptxas_report_names_each_kernel_instance():
    """Registers and spills of each tensor-core flash kernel instance from
    nvcc's `-Xptxas=-v` output, its name and template arguments read from
    its mangled symbol; other kernels are left out."""
    import chip_smoke

    ns = "_GLOBAL__N__beeea5df_26_flash_attention_mma_cu_b3273ed7"
    log = textwrap.dedent(f"""\
        ptxas info    : Compiling entry function '_ZN{len(ns)}{ns}20flash_fwd_mma_kernelILi64ELi2EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifb' for 'sm_90a'
        ptxas info    : Function properties for _ZN{len(ns)}{ns}20flash_fwd_mma_kernelILi64ELi2EEEvPK13__nv_bfloat16S3_S3_PS1_Pfiifb
            0 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
        ptxas info    : Used 168 registers, used 1 barriers
        ptxas info    : Function properties for _ZN47_GLOBAL__N__edab893f_14_lfq_entropy_cu_579610eb23lfq_entropy_grad_reduceILi18EEEvPKfS2_Pfifi
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 32 registers, used 0 barriers
        ptxas info    : Function properties for _ZN{len(ns)}{ns}24flash_bwd_dkv_mma_kernelILi128ELi4EEEvPK13__nv_bfloat16
            0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
        ptxas info    : Used 255 registers, used 1 barriers
    """)
    assert chip_smoke.ptxas_report(log) == [
        {"kernel": "flash_fwd_mma_kernel", "params": (64, 2), "spill_stores": 12,
         "spill_loads": 16, "registers": 168},
        {"kernel": "flash_bwd_dkv_mma_kernel", "params": (128, 4), "spill_stores": 0,
         "spill_loads": 0, "registers": 255},
    ]
