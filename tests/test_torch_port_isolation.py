"""PyTorch port: it stands alone.

  * importing every module of the port (and chip_smoke.py) loads neither jax
    nor the JAX package, and no source of the port, chip_smoke.py or the
    card tests imports either;
  * each host module the port keeps its own copy of gives what its JAX
    counterpart gives on the same numpy-seeded input (exactly: the copies
    are the same numpy code);
  * the entry points' device is the card unless the caller asks for the CPU.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import cpecan_signal_tpu as jpkg
import cpecan_signal_tpu_torch as tpkg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOTS = ("jax", "jaxlib", "cpecan_signal_tpu")
SCALE_FIELDS = ("scale", "shift", "var", "scale_sd", "var_sd")


def _imported_roots(path):
    """Top-level package names of every import statement in ``path``
    (relative imports excluded)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_nothing_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import cpecan_signal_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{JAX_ROOTS!r})\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 30   # the port's own host layers included
    sources = [os.path.join(REPO, "chip_smoke.py"),
               os.path.join(REPO, "tests", "test_torch_cuda.py")]
    for root, _dirs, files in os.walk(os.path.dirname(tpkg.__file__)):
        sources += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in sources:
        assert not _imported_roots(path) & set(JAX_ROOTS), path


def _pore_pair(seed):
    """The same random pore model as a JAX-package and a port PoreModel."""
    from cpecan_signal_tpu.models.pore_model import PoreModel as JPore
    from cpecan_signal_tpu_torch.constants import MODEL_PARAMS, NUM_OF_KMERS
    from cpecan_signal_tpu_torch.models.pore_model import PoreModel as TPore

    rng = np.random.default_rng(seed)
    m = np.zeros((NUM_OF_KMERS + 2, MODEL_PARAMS))
    m[:NUM_OF_KMERS] = rng.uniform(0.5, 90, (NUM_OF_KMERS, MODEL_PARAMS))
    skip = rng.uniform(0.01, 0.3, 60)
    return (JPore(0.9, m, 0.8, m.copy(), skip.copy()),
            TPore(0.9, m.copy(), 0.8, m.copy(), skip.copy()), rng)


def _case_sm3(seed):
    from cpecan_signal_tpu.models.state_machines import make_signal_sm3 as jmake
    from cpecan_signal_tpu_torch.models.state_machines import make_signal_sm3 as tmake

    jp, tp, rng = _pore_pair(seed)
    target = "".join(rng.choice(list("ACGTN"), 60, p=[0.24, 0.24, 0.24, 0.24, 0.04]))
    events = rng.uniform(40, 90, (70, 3))
    trans = {"gap_open_x": -3.0, "match_continue": -0.05}
    gaps = rng.uniform(-6, -1, 4096)
    out = []
    for make, pore in ((jmake, jp), (tmake, tp)):
        sm = make(pore, target, events, trans, gaps)
        xi, yi = np.meshgrid(np.arange(-1, 55), np.arange(-1, 70), indexing="ij")
        out.append([sm.start, sm.ragged_start, sm.end, sm.ragged_end, sm.kmer_ranks,
                    np.array([sm.tvals[k].val for k in sorted(sm.tvals)]),
                    sm.emissions(xi, yi), np.array([sm.spec.n_states, sm.spec.match_state])])
    return out


def _case_band(seed):
    from cpecan_signal_tpu.core.band import band_construct as jband
    from cpecan_signal_tpu.core.window import smooth_band as jsmooth
    from cpecan_signal_tpu_torch.core.band import band_construct as tband
    from cpecan_signal_tpu_torch.core.window import smooth_band as tsmooth

    rng = np.random.default_rng(seed)
    lX, lY = 300, 340
    xs = np.sort(rng.choice(np.arange(1, lX), 12, replace=False))
    ys = np.sort(rng.choice(np.arange(1, lY), 12, replace=False))
    anchors = np.stack([xs, ys], axis=1)
    out = []
    for band_construct, smooth_band in ((jband, jsmooth), (tband, tsmooth)):
        band = band_construct(anchors, lX, lY, 8)
        arrs = [band.xmyL, band.xmyR, np.array([band.lX, band.lY])]
        for wm in (64, 128):
            wb = smooth_band(band, width_multiple=wm)
            arrs += [wb.w0, wb.xmyL, wb.xmyR, np.array([wb.W, wb.lX, wb.lY])]
        out.append(arrs)
    return out


def _case_npread(seed, tmp_path):
    from cpecan_signal_tpu.io.npread import load_npread as jload
    from cpecan_signal_tpu_torch import synthetic as syn
    from cpecan_signal_tpu_torch.io.npread import load_npread as tload
    from cpecan_signal_tpu_torch.io.npread import write_npread

    rng = np.random.default_rng(seed)
    pore = syn.write_pore_model(str(tmp_path / "m.model"), rng)
    read = "".join(rng.choice(list("ACGT"), 200))
    path = str(tmp_path / "r.npRead")
    write_npread(path, syn.make_npread(read, pore, rng))
    out = []
    for load in (jload, tload):
        r = load(path)
        out.append([np.array([r.read_length]), np.frombuffer(r.twoD_read.encode(), np.uint8),
                    np.array([getattr(r.template_params, f) for f in SCALE_FIELDS]),
                    np.array([getattr(r.complement_params, f) for f in SCALE_FIELDS]),
                    r.template_event_map, r.template_events, r.complement_event_map,
                    r.complement_events])
    return out


def _case_fast5(seed, tmp_path):
    pytest.importorskip("h5py")
    from cpecan_signal_tpu.io.fast5 import fast5_to_npread as jload
    from cpecan_signal_tpu_torch.core.kmers import sequence_kmer_ranks
    from cpecan_signal_tpu_torch.io.fast5 import fast5_to_npread as tload
    from test_fast5 import _make_fast5

    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGT"), 80))
    path = str(tmp_path / "r.fast5")
    _make_fast5(path, seq, (50.0 + sequence_kmer_ranks(seq) % 40).astype(float), rng)
    out = []
    for load in (jload, tload):
        r = load(path)
        out.append([np.array([r.read_length]), np.frombuffer(r.twoD_read.encode(), np.uint8),
                    np.array([getattr(r.template_params, f) for f in SCALE_FIELDS]),
                    np.array([getattr(r.complement_params, f) for f in SCALE_FIELDS]),
                    r.template_event_map, r.template_events, r.complement_event_map,
                    r.complement_events])
    return out


def _case_kmers(seed):
    from cpecan_signal_tpu.core.kmers import sequence_kmer_ranks as jranks
    from cpecan_signal_tpu_torch.core.kmers import sequence_kmer_ranks as tranks

    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list("ACGTNacgt"), 500))
    return [[jranks(seq)], [tranks(seq)]]


def _case_hmm(seed):
    from cpecan_signal_tpu.em.accumulators import ContinuousPairHmm as JHmm
    from cpecan_signal_tpu_torch.em.accumulators import ContinuousPairHmm as THmm

    rng = np.random.default_rng(seed)
    trans = rng.uniform(0, 5, (3, 3))
    trans[2, 1] = 0.0          # a zero tally: log(0) stays -inf in both
    gaps = rng.uniform(0, 2, 4096)
    out = []
    for cls in (JHmm, THmm):
        h = cls(transitions=trans.copy(), kmer_gap=gaps.copy(), likelihood=-12.5)
        h.normalize()
        t, k = h.to_sm3_params()
        out.append([np.array([t[key] for key in sorted(t)]), k, h.transitions, h.kmer_gap])
    return out


def _case_amap(seed):
    from cpecan_signal_tpu.core import amap as jamap
    from cpecan_signal_tpu.io.cigar import CigarRecord as JRec
    from cpecan_signal_tpu_torch.core import amap as tamap
    from cpecan_signal_tpu_torch.io.cigar import CigarRecord as TRec

    rng = np.random.default_rng(seed)
    lx, ly = 120, 110
    pairs = np.stack([rng.integers(0, 10**7, 400), rng.integers(0, lx, 400),
                      rng.integers(0, ly, 400)], axis=1)
    sx = "".join(rng.choice(list("ACGT"), lx))
    sy = "".join(rng.choice(list("ACGT"), ly))
    out = []
    for amap, Rec in ((jamap, JRec), (tamap, TRec)):
        w = amap.reweight_aligned_pairs(pairs, lx, ly, 0.5)
        chain = amap.filter_pairs_to_ordered(w)
        ops = amap.pairs_to_cigar_ops(chain, lx, ly)
        rec = Rec("a", 0, lx, True, "b", ly, 0, False, 1.0, ops)
        split = amap.split_long_indels(rec, 3)
        out.append([w, chain, np.array([f"{o}{n}" for o, n in ops]),
                    np.array([r.to_line() for r in split]),
                    np.array([amap.score_by_identity(sx, sy, chain, g) for g in (False, True)]
                             + [amap.score_by_posterior(chain, lx, ly, g)
                                for g in (False, True)])])
    return out


def _case_hdp_nanopore(seed):
    from cpecan_signal_tpu.hdp import nanopore as jn
    from cpecan_signal_tpu_torch.hdp import nanopore as tn

    rng = np.random.default_rng(seed)
    mus, taus = rng.uniform(40, 90, 200), rng.uniform(0.5, 2.0, 200)
    out = []
    for mod in (jn, tn):
        arrs = [np.array(mod.mle_normal_inverse_gamma(mus, taus))]
        for alphabet in ("ACGT", "ACEGOT"):
            for topology in mod.HDP_TYPES:
                parents, depth = mod._topology_parents(topology, alphabet, 3)
                arrs += [parents, np.array([depth])]
            ids = [mod.kmer_id(k, alphabet) for k in ("AAA", "CGT", "TTA")]
            arrs += [np.array(ids), np.array([mod.id_to_kmer(i, alphabet, 3) == k
                                              for i, k in zip(ids, ("AAA", "CGT", "TTA"))])]
        out.append(arrs)
    return out


def _case_hdp_metrics(seed):
    from cpecan_signal_tpu.hdp import metrics as jm
    from cpecan_signal_tpu_torch.hdp import metrics as tm

    rng = np.random.default_rng(seed)
    grid = np.linspace(30, 90, 200)
    p, q = rng.uniform(0.01, 1, 200), rng.uniform(0.01, 1, 200)
    return [[np.array([m.kl_divergence(grid, p, q), m.hellinger_distance(grid, p, q),
                       m.l2_distance(grid, p, q), m.shannon_jensen_distance(grid, p, q)])]
            for m in (jm, tm)]


def _case_alignments(seed, tmp_path):
    from cpecan_signal_tpu.analysis import alignments as ja
    from cpecan_signal_tpu_torch.analysis import alignments as ta

    rng = np.random.default_rng(seed)
    path = str(tmp_path / "a.tsv")
    with open(path, "w") as fh:
        for i in range(80):
            kmer = "".join(rng.choice(list("ACGT"), 6))
            fh.write("\t".join(map(str, [
                "chr", i, kmer, f"read{i % 3}", "tc"[i % 2], i // 2, 60.0 + i % 7, 1.5,
                0.002 * (i % 9 + 1), kmer, 60.0, 1.5, round(rng.uniform(0, 1), 3),
                59.0 + i % 5, 59.5])) + "\n")
    out = []
    for mod in (ja, ta):
        t = mod.AlignmentTable.read(path)
        hist = mod.kmer_event_histograms(t, threshold=0.2)
        stats = mod.duration_analysis(t)
        cmp = mod.summarize_alignments(t, t.by_strand("t"))
        out.append([np.concatenate([hist[k] for k in sorted(hist)]),
                    np.array(sorted(stats.items())), np.array(sorted(cmp.items())),
                    np.array([repr(r) for r in mod.process_posteriors(t, 0.3)]),
                    np.array([repr(r) for r in mod.make_build_alignment(
                        [(t, None), (t, "E")], threshold=0.1, max_per_kmer=2)])])
    return out


@pytest.mark.parametrize("case", ["make_signal_sm3", "band_construct+smooth_band",
                                  "load_npread", "fast5_to_npread", "sequence_kmer_ranks",
                                  "ContinuousPairHmm.to_sm3_params", "amap",
                                  "hdp.nanopore", "hdp.metrics", "analysis.alignments"])
def test_copied_host_module_matches_jax(case, tmp_path):
    """The port's copy of a host module gives exactly what the JAX package's
    module gives, on the same numpy-seeded input."""
    seed = 101
    want, got = {
        "make_signal_sm3": lambda: _case_sm3(seed),
        "band_construct+smooth_band": lambda: _case_band(seed),
        "load_npread": lambda: _case_npread(seed, tmp_path),
        "fast5_to_npread": lambda: _case_fast5(seed, tmp_path),
        "sequence_kmer_ranks": lambda: _case_kmers(seed),
        "ContinuousPairHmm.to_sm3_params": lambda: _case_hmm(seed),
        "amap": lambda: _case_amap(seed),
        "hdp.nanopore": lambda: _case_hdp_nanopore(seed),
        "hdp.metrics": lambda: _case_hdp_metrics(seed),
        "analysis.alignments": lambda: _case_alignments(seed, tmp_path),
    }[case]()
    assert len(want) == len(got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_copies_name_their_source():
    """Every copied host module exists in the JAX package at the same
    relative path and names it in its docstring."""
    port_root = os.path.dirname(tpkg.__file__)
    jax_root = os.path.dirname(jpkg.__file__)
    copies = []
    for root, _dirs, files in os.walk(port_root):
        for f in files:
            path = os.path.join(root, f)
            if not f.endswith(".py"):
                continue
            with open(path) as fh:
                doc = ast.get_docstring(ast.parse(fh.read())) or ""
            rel = os.path.relpath(path, port_root)
            if f"Copied from ``cpecan_signal_tpu/{rel}``" in doc:
                copies.append(rel)
                assert os.path.exists(os.path.join(jax_root, rel)), rel
    assert len(copies) == 23, copies


def test_resolve_device_defaults_to_the_card(monkeypatch):
    """With the variable unset (or empty) the entry points' device is the
    card: here, without one, resolving it raises; it never returns the
    CPU."""
    from cpecan_signal_tpu_torch.utils.device import resolve_device

    for value in (None, ""):
        if value is None:
            monkeypatch.delenv("SIGALIGN_PLATFORM", raising=False)
        else:
            monkeypatch.setenv("SIGALIGN_PLATFORM", value)
        if torch.cuda.is_available():
            assert resolve_device().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no usable CUDA device"):
                resolve_device()
