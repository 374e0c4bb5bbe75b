"""The port runs where jax is not installed.

In a fresh interpreter whose import system refuses `jax` and `jaxlib`,
every kaldi_tpu_torch module and chip_smoke.py's helpers import, and a
small decode runs on the CPU. (kaldi_tpu/decoder/__init__.py imports the
jax decoders, so reaching into kaldi_tpu.decoder from the port would fail
here.)
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, importlib.abc, pkgutil, sys

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, BlockJax())
import numpy as np
import torch
torch.set_num_threads(2)
import kaldi_tpu_torch
names = [m.name for m in pkgutil.walk_packages(kaldi_tpu_torch.__path__,
                                               "kaldi_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
from kaldi_tpu_torch.decoder.csr_beam import CsrBeamDecoder, CsrBeamOpts
g = chip_smoke.star_hub_graph(40)
dec = CsrBeamDecoder(g, CsrBeamOpts(beam=1e9, max_active=32,
                                    expand_budget=256, hub_threshold=8))
ll = np.random.RandomState(0).randn(2, 10, 41).astype(np.float32)
res = dec.decode(ll, np.array([10, 6], np.int32))
assert all(r is not None and r[1] for r in res), res
assert chip_smoke.wer([[1, 2, 3]], [[1, 3]]) == 100.0 / 3
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
       or m.startswith("kaldi_tpu.")]
assert not bad, bad
print("modules", len(names))
"""


def test_port_imports_and_decodes_without_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split("modules")[-1]) >= 15, r.stdout
