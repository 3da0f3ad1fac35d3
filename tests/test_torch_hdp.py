"""PyTorch port: the hdp package and cli/build_hdp on the CPU against the JAX
package.

  * the native Gibbs core: the port's source is a copy of the JAX package's,
    built into build/torch_kernels/ and loaded from there; neither package
    builds or loads the other's library (a fresh process's memory maps);
  * carrying HDPs across: each package reads the other's .nhdp, chain and
    HdpHmm files, and the density tables, factor counts and assignments are
    equal bit for bit;
  * the Gibbs chain: for the same seed and assignments (at
    OMP_NUM_THREADS=1) the two packages give tables that agree only as
    samples of one posterior do.  The chain visits each DP's factors in the
    order of a hash set of pointers (std::unordered_set<Factor*>,
    csrc/hdp_core.cpp), so the seed fixes the random stream but not the
    visiting order, and two runs of one package in one process already give
    different tables (the same source in both packages: not a fault of the
    port).  So the packages are compared through a robust statistic of each
    k-mer's density, its median on the grid: on 8 k-mers of at least 150
    points each (sd 1.5 pA) it lies within 2.0 pA of the other package's and
    of the level the points were drawn at, where 16 builds alternating
    between the packages spread by at most 0.9 pA (the density mean and
    mode spread by up to 2.7 and 4.9 pA: a chain may leave a small far
    component);
  * cli/build_hdp from an alignment TSV and from expectations files, as the
    JAX CLI, with the same check.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from cpecan_signal_tpu.em.accumulators import HdpHmm as JHmm
from cpecan_signal_tpu.hdp import nanopore as jn
from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.em.accumulators import HdpHmm as THmm
from cpecan_signal_tpu_torch.hdp import core as tcore
from cpecan_signal_tpu_torch.hdp import nanopore as tn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (30.0, 120.0, 120)
MEDIAN_TOL = 2.0   # pA between the density medians of two chains (see above)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hdp") / "synthetic.model")
    syn.write_pore_model(path, np.random.default_rng(1))
    return path


def _assignments(seed=9, n_kmers=8, per=150):
    rng = np.random.default_rng(seed)
    kmers = ["".join(rng.choice(list("ACGT"), 6)) for _ in range(n_kmers)]
    levels = rng.uniform(50, 85, n_kmers)
    ks, ms = [], []
    for k, m in zip(kmers, levels):
        ks += [k] * per
        ms += list(rng.normal(m, 1.5, per))
    order = rng.permutation(len(ks))
    return [ks[i] for i in order], [ms[i] for i in order], dict(zip(kmers, levels))


def _density_medians(nhdp, kmers):
    """Each k-mer's density median on the HDP's grid."""
    g = nhdp.hdp.grid
    out = {}
    for k in kmers:
        c = np.cumsum(nhdp.kmer_density(k, g))
        out[k] = float(g[np.searchsorted(c / c[-1], 0.5)])
    return out


def test_native_source_is_a_copy():
    with open(os.path.join(REPO, "native", "hdp_core.cpp"), "rb") as a, \
            open(tcore.SOURCE, "rb") as b:
        assert a.read() == b.read()


def test_each_package_loads_its_own_library():
    """A fresh process builds an HDP with the port, then with the JAX
    package: the port's library lies in build/torch_kernels/ and is the one
    loaded; the JAX package's own library is neither rebuilt nor touched by
    the port."""
    code = (
        "import numpy as np, os\n"
        "from cpecan_signal_tpu_torch.hdp import core\n"
        "h = core.HierarchicalDirichletProcess(np.array([1, -1]), 2, 50., 1., 2., 1.,"
        " 30., 90., 50, gamma=[1., 1.])\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(core.loaded_library())\n"
        "print(str(core.loaded_library()) in maps, 'native/libhdp_core.so' in maps)\n")
    native = os.path.join(REPO, "native", "libhdp_core.so")
    before = os.path.getmtime(native) if os.path.exists(native) else None
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    path, flags = res.stdout.split("\n")[:2]
    assert os.path.dirname(path) == os.path.join(REPO, "build", "torch_kernels")
    assert os.path.basename(path).startswith("libhdp_core_")
    assert flags == "True False"
    after = os.path.getmtime(native) if os.path.exists(native) else None
    assert before == after


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_nhdp_files_carry_across(direction, model, tmp_path):
    """A serialized NanoporeHDP (and its chain) written by one package and
    read by the other gives the writer's density table bit for bit."""
    kmers, means, _levels = _assignments()
    make, read, read_chain = ((jn.build_nanopore_hdp, tn.deserialize_nhdp,
                               tn.deserialize_nhdp)
                              if direction == "jax_to_port" else
                              (tn.build_nanopore_hdp, jn.deserialize_nhdp,
                               jn.deserialize_nhdp))
    nhdp = make("flat", model, alphabet="ACGT", grid=GRID, seed=5)
    nhdp.set_assignments(kmers, means)
    nhdp.gibbs(num_samples=20, burn_in=100, thinning=5)
    chain = str(tmp_path / "chain.nhdp")
    nhdp.serialize_chain(chain)
    nhdp.finalize()
    path = str(tmp_path / "w.nhdp")
    nhdp.serialize(path)
    back = read(path)
    assert (back.alphabet, back.kmer_length, back.topology) == ("ACGT", 6, "flat")
    np.testing.assert_array_equal(back.density_table(), nhdp.density_table())
    live = read_chain(chain)
    np.testing.assert_array_equal(live.hdp.factor_counts(), nhdp.hdp.factor_counts())
    assert live.hdp.samples_taken == nhdp.hdp.samples_taken


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_hdphmm_files_carry_across(direction, tmp_path):
    rng = np.random.default_rng(4)
    W, R = (JHmm, THmm) if direction == "jax_to_port" else (THmm, JHmm)
    kmers, means, _levels = _assignments(n_kmers=3, per=5)
    hmm = W(transitions=rng.uniform(0, 1, (3, 3)), threshold=0.01, likelihood=-42.5,
            kmer_assignments=kmers, event_assignments=means)
    path = str(tmp_path / "e.hmm")
    hmm.write(path)
    back = R.load(path)
    again = W.load(path)
    np.testing.assert_array_equal(back.transitions, again.transitions)
    assert back.kmer_assignments == kmers
    assert back.event_assignments == again.event_assignments
    assert (back.threshold, back.likelihood) == (again.threshold, again.likelihood)


def _chain_tables(model: str) -> str:
    """Density medians of one build per package, then a second JAX build,
    in a fresh process at OMP_NUM_THREADS=1."""
    code = (
        "import json, sys\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_hdp import _assignments, _density_medians, GRID\n"
        "from cpecan_signal_tpu.hdp import nanopore as jn\n"
        "from cpecan_signal_tpu_torch.hdp import nanopore as tn\n"
        "kmers, means, levels = _assignments()\n"
        "out = []\n"
        f"for mod in (jn, tn, jn):\n"
        f"    h = mod.build_nanopore_hdp('flat', {model!r}, alphabet='ACGT', grid=GRID,"
        " seed=5)\n"
        "    h.set_assignments(kmers, means)\n"
        "    h.gibbs(num_samples=40, burn_in=400, thinning=10)\n"
        "    h.finalize()\n"
        "    out.append(_density_medians(h, levels))\n"
        "print(json.dumps([out, levels]))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600, env=env)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()[-1]


def test_gibbs_chain_agrees_with_jax(model):
    import json

    (jax1, port, jax2), levels = json.loads(_chain_tables(model))
    for k, level in levels.items():
        assert abs(port[k] - jax1[k]) < MEDIAN_TOL, (k, port[k], jax1[k], jax2[k])
        for got in (port, jax1, jax2):
            assert abs(got[k] - level) < MEDIAN_TOL, (k, got[k], level)


def _write_tsv(path, kmers, means, strands):
    """A 15-column alignment TSV carrying (strand, k-mer, descaled mean) in
    the columns the HDP build reads (4, 9, 13)."""
    with open(path, "w") as fh:
        for k, m, s in zip(kmers, means, strands):
            row = ["ref", "0", k, "r", s, "0", "1", "1", "0.01", k, "1", "1", "0.9",
                   f"{m:f}", "1"]
            fh.write("\t".join(row) + "\n")


def test_build_hdp_cli_matches_jax(model, tmp_path):
    """cli/build_hdp --alignments (both strands) by each package: every
    k-mer's density median agrees within MEDIAN_TOL; then the port's update
    from an expectations file, read back by the JAX package, centres each
    k-mer within MEDIAN_TOL of its level."""
    from cpecan_signal_tpu.cli import build_hdp as jcli
    from cpecan_signal_tpu_torch.cli import build_hdp as tcli

    kmers, means, levels = _assignments(per=450)
    strands = ["t" if i % 3 else "c" for i in range(len(kmers))]
    tsv = str(tmp_path / "a.tsv")
    _write_tsv(tsv, kmers, means, strands)
    gibbs = ["--samples", "40", "--burnIn", "400", "--thinning", "10"]
    got = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        t, c = str(tmp_path / f"{name}_t.nhdp"), str(tmp_path / f"{name}_c.nhdp")
        assert cli.main(["-a", tsv, "-T", model, "-C", model, "-v", t, "-w", c,
                         *gibbs]) == 0
        got[name] = (t, c)
    for strand in (0, 1):
        j = jn.deserialize_nhdp(got["jax"][strand])
        p = tn.deserialize_nhdp(got["port"][strand])
        assert (p.alphabet, p.topology) == (j.alphabet, j.topology) == ("ACEGOT", "flat")
        jm, pm = _density_medians(j, levels), _density_medians(p, levels)
        for k in levels:
            assert abs(pm[k] - jm[k]) < MEDIAN_TOL, (strand, k, pm[k], jm[k])
    # update: the template HDP from an expectations file of the same points
    exp = str(tmp_path / "t.hmm")
    THmm(transitions=np.eye(3), threshold=0.01, kmer_assignments=kmers,
         event_assignments=means).write(exp)
    assert tcli.main(["-v", got["port"][0], "-w", got["port"][1], "-t", exp,
                      *gibbs]) == 0
    updated = jn.deserialize_nhdp(got["port"][0])
    um = _density_medians(updated, levels)
    for k, level in levels.items():
        assert abs(um[k] - level) < MEDIAN_TOL, (k, um[k], level)
