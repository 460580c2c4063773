"""echr_tpu_torch runs without jax and without echr_tpu, and its seeded
init builds the same param tree as echr_tpu.models.registry.

The subprocess imports every module of the port (its probes included),
builds its configuration and data from the port alone, serves a tiny CPU
slice (greedy and beam) from the port's own init and from a JAX format-v2
checkpoint, takes one tiny training step, writes and reads it back as a
checkpoint, evaluates a split with its metrics, renders a caption and builds
an IoU grid through its host library (echr_tpu_torch/native), and checks
that neither jax nor any echr_tpu or experiments module entered
sys.modules.
"""
import os
import pkgutil
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_ops import small_cfg

import echr_tpu_torch
from echr_tpu.models.registry import init_captioner as jax_init_captioner
from echr_tpu.models.registry import init_tap as jax_init_tap

from echr_tpu_torch.bridge import captioner_to_jax, tap_to_jax
from echr_tpu_torch.models.registry import init_captioner, init_tap

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "echr_tpu_torch"
# an import of jax, of the JAX package (echr_tpu, echr_tpu.*; not echr_tpu_torch)
# or of its Pallas probes (experiments, experiments.*)
FOREIGN_IMPORT = re.compile(
    r"^\s*(import jax|from jax)|^\s*(from|import)\s+(echr_tpu|experiments)(\.|\s|$)", re.M)


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "echr_tpu_torch."))


def _shapes(tree):
    return jax.tree.map(lambda x: tuple(np.shape(x)), tree)


@pytest.mark.parametrize("fst_posit", [True, False])
def test_init_tree_matches_jax_registry(fst_posit):
    cfg = small_cfg(**{"fusion.use_posit": fst_posit})
    g = torch.Generator().manual_seed(0)
    tap, cg = init_tap(g, cfg), init_captioner(g, cfg)
    k = jax.random.PRNGKey(0)
    want_tap = jax.eval_shape(lambda: jax_init_tap(k, cfg))
    want_cg = jax.eval_shape(lambda: jax_init_captioner(k, cfg))
    assert _shapes(tap_to_jax(tap)) == _shapes(want_tap)
    assert _shapes(captioner_to_jax(cg, cfg)) == _shapes(want_cg)


def test_init_uniform_bounds():
    """Every leaf lies inside its JAX init bound: 1/sqrt(fan_in) for
    Linears, 1/sqrt(H) for LSTM cells, 0.1 for embed and logit weight."""
    cfg = small_cfg()
    cg = init_captioner(torch.Generator().manual_seed(1), cfg)
    d = cfg.fusion.d_feats
    H = cfg.decoder.CG_rnn_size
    assert cg.decoder.embed.abs().max() <= 0.1
    assert cg.decoder.logit.weight.abs().max() <= 0.1
    assert torch.all(cg.decoder.logit.bias == 0)
    assert cg.decoder.core.layer0.weight_ih.abs().max() <= 1 / np.sqrt(H)
    assert cg.fusion.out.weight.abs().max() <= 1 / np.sqrt(d)
    att = cg.decoder.core.attention.ctx2att
    assert att.weight.abs().max() <= 1 / np.sqrt(att.weight.shape[1])
    # seeded: the same generator seed gives the same tree
    again = init_captioner(torch.Generator().manual_seed(1), cfg)
    assert torch.equal(again.decoder.embed, cg.decoder.embed)


def test_port_sources_stay_off_jax_and_library_kernels():
    """No module of the port imports jax, echr_tpu or the JAX probes under
    experiments/, or calls a library kernel; chip_smoke.py and
    kernel_turns.py import none of the three."""
    banned = re.compile(r"scaled_dot_product_attention|torch\.compile|flash_attn|xformers")
    sources = [p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts]
    assert len(sources) >= 25
    for path in sources + [REPO / "chip_smoke.py", REPO / "kernel_turns.py"]:
        text = path.read_text()
        assert not FOREIGN_IMPORT.search(text), path
        assert path.name == "chip_smoke.py" or not banned.search(text), path
    assert FOREIGN_IMPORT.search("import echr_tpu.config\n")
    assert FOREIGN_IMPORT.search("  from echr_tpu import native\n")
    assert not FOREIGN_IMPORT.search("from echr_tpu_torch.config import Config\n")
    assert FOREIGN_IMPORT.search("from experiments import probe_greedy_head\n")
    assert not FOREIGN_IMPORT.search("from echr_tpu_torch.experiments import probe_device\n")
    assert PKG / "experiments" / "probe_mxu_vpu_overlap.py" in sources
    assert {PKG / "experiments" / "recipe.py",
            PKG / "experiments" / "probe_trained_e2e.py"} <= set(sources)


_CHILD = textwrap.dedent("""
    import importlib, sys
    import numpy as np, torch
    for name in {modules!r}:
        importlib.import_module(name)
    from echr_tpu_torch.config import flagship_config
    from echr_tpu_torch.models.registry import init_captioner, init_tap
    from echr_tpu_torch.serve import CaptionRequest, CaptionService, from_checkpoint
    cfg = flagship_config()
    cfg = cfg.replace_in("data", lda_dim=16, time_buckets=(128,))
    cfg = cfg.replace_in("tap", video_dim=24, hidden_dim=32, K=32)
    cfg = cfg.replace_in("fusion", n_head=4, d_feats=32, d_o=32)
    cfg = cfg.replace_in("decoder", CG_rnn_size=32, CG_input_encoding_size=32,
                         CG_att_hid_size=128, CG_vocab_size=50, CG_seq_length=8)
    g = torch.Generator().manual_seed(0)
    vocab = {{str(i): "w%d" % i for i in range(1, 51)}}
    r = np.random.RandomState(0)
    reqs = [CaptionRequest("v%d" % i, r.randn(90 + 9 * i, 24).astype(np.float32), 20.0)
            for i in range(3)]
    for svc in (CaptionService(cfg, init_tap(g, cfg), init_captioner(g, cfg), vocab,
                               device="cpu", batch_videos=2, topN=6),
                from_checkpoint({ckpt!r}, device="cpu", batch_videos=2, topN=6),
                from_checkpoint({ckpt!r}, device="cpu", batch_videos=2, topN=6, beam_size=2)):
        res = svc.caption(reqs)
        assert sorted(res) == ["v0", "v1", "v2"], res
        assert all(len(c) == 6 for c in res.values())
    from echr_tpu_torch.data.batcher import make_batch
    from echr_tpu_torch.data.dataset import SyntheticDataset
    from echr_tpu_torch.engine import steps
    from echr_tpu_torch.engine.train import _collate
    cfg = cfg.replace_in("tap", prop_sample_num=8).replace_in(
        "data", synthetic_vocab_size=50, synthetic_seq_length=8)
    ds = SyntheticDataset(cfg, num_videos=4, seed=3)
    batch = _collate([make_batch(ds.get_example(i), cfg, np.random.RandomState(i),
                                 w1=ds.w1)[0] for i in range(2)])
    st = steps.init_train_state(cfg, init_tap(g, cfg), init_captioner(g, cfg))
    st, m = steps.train_step(st, steps.batch_to_device(batch, "cpu"),
                             torch.Generator().manual_seed(0), cfg, "tap_cg")
    assert st.step == 1 and np.isfinite(m["loss"]), m
    from echr_tpu_torch.engine import checkpoint
    checkpoint.save_checkpoint("t.ckpt", st, cfg, iteration=1, epoch=0, best_val_score=0.0)
    again = checkpoint.load_checkpoint("t.ckpt", "cpu")["state"]
    assert again.step == 1 and len(again.cg_opt.state) == len(list(st.cg.parameters()))
    from echr_tpu_torch.data.loader import Loader
    from echr_tpu_torch.engine.evaluate import eval_split_batched
    preds, score, loss = eval_split_batched(
        st.tap, st.cg, Loader(ds, cfg, process_index=0, process_count=1), cfg, "eval.json",
        {{"topN": 6, "val_all_metrics": True}}, batch_videos=2, device="cpu")
    assert preds and np.isfinite(loss).all() and len(score["METEOR"]) == 4, (preds, score)
    import shutil
    from echr_tpu_torch import native
    from echr_tpu_torch.data.labels import iou_grid
    from echr_tpu_torch.utils.text import decode_sequence
    native.reset_counts()
    assert decode_sequence(vocab, np.array([[3, 1, 0, 2]])) == ["w3 w1"]
    iou, gts, mask = iou_grid([(2, 9), (4, 20)], 32, 8)
    assert iou.shape == (32, 8) and 0.9 < iou.max() <= 1.0 and gts.max() == 1
    on = int(native.available())
    assert on == (shutil.which("g++") is not None), on
    assert native.counts() == dict(iou_grid=on, nms_temporal=0, nms_external=0,
                                   render_captions=on), native.counts()
    foreign = sorted(m for m in sys.modules if m in ("jax", "echr_tpu", "experiments")
                     or m.startswith(("jax.", "echr_tpu.", "experiments.")))
    assert not foreign, foreign
    print("NOJAX_OK")
""")


def test_port_runs_without_jax(tmp_path):
    from test_torch_serve import _params, _save_jax_checkpoint, _vocab

    cfg = small_cfg()
    tap, cg = _params(cfg)
    ckpt = tmp_path / "m.ckpt"
    _save_jax_checkpoint(ckpt, cfg, tap, cg, _vocab(cfg))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD.format(modules=_all_modules(), ckpt=str(ckpt))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NOJAX_OK" in proc.stdout
    assert len(_all_modules()) >= 18 and echr_tpu_torch.__version__
    assert "echr_tpu_torch.experiments.probe_streaming_head2" in _all_modules()
    assert {"echr_tpu_torch.engine.checkpoint", "echr_tpu_torch.utils.tb",
            "echr_tpu_torch.cli.train", "echr_tpu_torch.cli.eval",
            "echr_tpu_torch.cli.score", "echr_tpu_torch.native",
            "echr_tpu_torch.experiments.recipe",
            "echr_tpu_torch.experiments.probe_trained_e2e"} <= set(_all_modules())
