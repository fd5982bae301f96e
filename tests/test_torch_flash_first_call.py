"""The float32 flash twins' first call in a fresh process gives the bits
of a later call: 24 fresh processes at once, each calling the forward
(``flash_attention_plain``) or the backward (``flash_attention_bwd_plain``)
first thing and again, without a logit cap and with gemma2's cap of 50
(a ``tanh`` before the first ``exp``). Without the twins' single-threaded
``exp`` first (``models/attention.py`` ``_init_cpu_math``), torch's first
multi-threaded exp, log or tanh of a process could put one thread's chunk
up to 1.5e-4 off: the float32 card test against the twin then failed its
2e-5 tolerance. Each process runs 32 intra-op threads, where the fault
showed in 3-5% of processes (``tools/cpu_first_call_probe.py``; at 8 it is
rarer), so an unrepaired twin fails this test in most runs. Needs torch
and numpy only, so that it runs on the card's machine too."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
pytest.importorskip("numpy")


# the float32 twin's first call in a fresh process, then a later call: the
# card test's failing shape (dh 16, GQA 4:2, 128 tokens, kv_block 64), one
# [2,2,2,128,64] score block a step. The backward takes a drawn out and lse
# (its arithmetic does not need the forward's), so its exp is the first
_FIRST_CALL = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(32)
from repro_torch.models.attention import (flash_attention_bwd_plain,
                                          flash_attention_plain)
rng = np.random.default_rng(int(sys.argv[1]))
q, k, v, out, dout = (
    torch.from_numpy(rng.normal(size=s).astype(np.float32))
    for s in ((2, 4, 128, 16), (2, 2, 128, 16), (2, 2, 128, 16),
              (2, 4, 128, 16), (2, 4, 128, 16)))
lse = torch.from_numpy(rng.uniform(1, 4, (2, 4, 128)).astype(np.float32))
cap = None if sys.argv[3] == "None" else float(sys.argv[3])
kw = dict(causal=True, kv_block=64, logit_cap=cap)
if sys.argv[2] == "fwd":
    calls = [flash_attention_plain(q, k, v, return_lse=True, **kw)
             for _ in range(2)]
else:
    calls = [flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
             for _ in range(2)]
print(all(torch.equal(a, b) for a, b in zip(*calls)))
"""


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_flash_twin_first_call_in_a_fresh_process_is_reproducible(which,
                                                                  cap):
    """24 fresh processes at once, each calling the float32 twin first
    thing and again: both calls give the same bits in every one."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL, str(i),
                               which, str(cap)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(24)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs][:1]
    assert [o.strip() for o, _ in outs] == ["True"] * 24
