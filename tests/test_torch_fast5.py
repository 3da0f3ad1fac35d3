"""PyTorch port: fast5 reads through io/fast5 and cli/signal_align.

Synthetic two-strand reads are written as dragonet-1.15.0 fast5 files with
h5py (one alignment-table row per k-mer, the read's own events and event
maps, unit scale parameters, no drift), as tests/test_fast5.py writes its
file, and as npRead files of the same reads:

  * the port's fast5 copy reads back exactly the synthetic read;
  * a directory holding a fast5 and an npRead goes through both
    signal_align CLIs on the CPU, and their TSVs agree within the tolerance
    of tests/test_torch_slice.py::test_signal_align_cli_matches_jax_cli;
  * a directory of fast5 files alone aligns every read, each to the rows
    its npRead gives.
"""

import os

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from cpecan_signal_tpu_torch import synthetic as syn
from cpecan_signal_tpu_torch.cli import signal_align as sa
from cpecan_signal_tpu_torch.io.fast5 import fast5_to_npread
from cpecan_signal_tpu_torch.io.npread import write_npread
from test_torch_generic_cli import assert_columns_agree

KMER = 6
SCALE_FIELDS = ("scale", "shift", "var", "scale_sd", "var_sd")


def write_fast5(path, read):
    """A dragonet-1.15.0 fast5 of a synthetic NanoporeRead: alignment-table
    row i is k-mer i with the first template event of k-mer i and the first
    complement event of its reverse complement; the events keep their
    (mean, noise, duration); the models' scale attributes are the read's,
    with drift 0."""
    seq = read.twoD_read
    n = len(seq) - KMER + 1
    with h5py.File(path, "w") as f:
        base = f.create_group("Analyses/Basecall_2D_000")
        base.attrs["dragonet version"] = "1.15.0"
        table = np.zeros(n, dtype=[("template", "<i8"), ("complement", "<i8"),
                                   ("kmer", f"S{KMER}")])
        table["template"] = read.template_event_map[:n]
        table["complement"] = read.complement_event_map[:n]
        table["kmer"] = [seq[i:i + KMER].encode() for i in range(n)]
        base.create_group("BaseCalled_2D").create_dataset("Alignment", data=table)
        for strand, events, params in (
                ("template", read.template_events, read.template_params),
                ("complement", read.complement_events, read.complement_params)):
            ev = np.zeros(len(events), dtype=[("mean", "<f8"), ("start", "<f8"),
                                              ("stdv", "<f8"), ("length", "<f8")])
            ev["mean"], ev["stdv"], ev["length"] = events[:, 0], events[:, 1], events[:, 2]
            ev["start"] = np.cumsum(events[:, 2]) - events[0, 2]
            g = base.create_group(f"BaseCalled_{strand}")
            g.create_dataset("Events", data=ev)
            model = np.zeros(4, dtype=[("kmer", f"S{KMER}"), ("level_mean", "<f8"),
                                       ("level_stdv", "<f8"), ("sd_mean", "<f8"),
                                       ("sd_stdv", "<f8")])
            md = g.create_dataset("Model", data=model)
            md.attrs.update({f: getattr(params, f) for f in SCALE_FIELDS})
            md.attrs["drift"] = 0.0


def _reads(tmp_path, n_reads, seed=11):
    """(model path, reference path, [NanoporeRead]) of ``n_reads`` reads of
    90-150 bases drawn from a random 2500-base reference."""
    rng = np.random.default_rng(seed)
    model = str(tmp_path / "synthetic.model")
    pore = syn.write_pore_model(model, rng)
    ref = str(tmp_path / "ref.fa")
    ref_seq = syn.write_reference(ref, 2500, rng)
    reads = []
    for _ in range(n_reads):
        n_bases = int(rng.integers(90, 150))
        lo = int(rng.integers(0, len(ref_seq) - n_bases - 1))
        read = syn.evolve_sequence(ref_seq[lo:lo + n_bases], rng, 0.03, 0.01)
        reads.append(syn.make_npread(read, pore, rng))
    return model, ref, reads


def _write(directory, reads, kinds):
    """read{i:03d}.<kind> for each read; returns the directory."""
    os.makedirs(directory, exist_ok=True)
    for i, (read, kind) in enumerate(zip(reads, kinds)):
        path = os.path.join(directory, f"read{i:03d}.{kind}")
        (write_fast5 if kind == "fast5" else write_npread)(path, read)
    return str(directory)


def _tsv(out_dir):
    with open(os.path.join(out_dir, "posteriors.tsv")) as fh:
        return [line.rstrip("\n").split("\t") for line in fh]


def test_fast5_copy_reads_the_synthetic_read(tmp_path):
    """The port's fast5_to_npread gives back the read the file was written
    from: sequence, event maps, events and scale parameters."""
    _model, _ref, (read,) = _reads(tmp_path, 1)
    path = str(tmp_path / "r.fast5")
    write_fast5(path, read)
    got = fast5_to_npread(path)
    assert got.twoD_read == read.twoD_read and got.read_length == read.read_length
    for field in ("template_event_map", "template_events", "complement_event_map",
                  "complement_events"):
        np.testing.assert_array_equal(getattr(got, field), getattr(read, field))
    for strand in ("template_params", "complement_params"):
        assert getattr(got, strand) == getattr(read, strand)


def test_signal_align_fast5_matches_jax_cli(tmp_path, monkeypatch):
    """A directory of one fast5 and one npRead: both CLIs (-s) align both
    reads on both strands, and the port's rows agree with the JAX CLI's per
    read and strand to <= 2 pairs and 1.2e-3 posterior, and in every other
    column on the rows both write."""
    from cpecan_signal_tpu.cli import signal_align as jsa

    model, ref, reads = _reads(tmp_path, 2)
    directory = _write(tmp_path / "reads", reads, ("fast5", "npRead"))
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    args = ["-d", directory, "-r", ref, "-T", model, "-C", model, "-s"]
    assert sa.main(args + ["-o", str(tmp_path / "port")]) == 0
    assert jsa.main(args + ["-o", str(tmp_path / "jax")]) == 0
    rows, jrows = _tsv(tmp_path / "port"), _tsv(tmp_path / "jax")
    keys = {(name, s) for name in ("read000.fast5", "read001.npRead") for s in "tc"}
    assert {(r[3], r[4]) for r in rows} == keys
    assert {(r[3], r[4]) for r in jrows} == keys
    for key in keys:
        got = {(r[1], r[5]): float(r[12]) for r in rows if (r[3], r[4]) == key}
        want = {(r[1], r[5]): float(r[12]) for r in jrows if (r[3], r[4]) == key}
        common = set(got) & set(want)
        assert len(common) >= max(len(got), len(want)) - 2, key
        assert max(abs(got[k] - want[k]) for k in common) < 1.2e-3
    assert_columns_agree(rows, jrows)


def test_signal_align_fast5_directory(tmp_path, monkeypatch, capsys):
    """A directory of fast5 files alone: the port aligns every read, and
    each read's rows equal, but for the label column, those of the same
    read given as an npRead."""
    model, ref, reads = _reads(tmp_path, 2, seed=12)
    monkeypatch.setenv("SIGALIGN_PLATFORM", "cpu")
    monkeypatch.setattr(sa.random, "shuffle", lambda paths: None)
    tables = {}
    for kind in ("fast5", "npRead"):
        directory = _write(tmp_path / kind, reads, (kind, kind))
        assert sa.main(["-d", directory, "-r", ref, "-T", model, "-C", model, "-s",
                        "-o", str(tmp_path / f"out_{kind}")]) == 0
        assert "aligned 2/2 reads" in capsys.readouterr().out
        tables[kind] = [r[:3] + [r[3].rsplit(".", 1)[0]] + r[4:]
                        for r in _tsv(tmp_path / f"out_{kind}")]
    assert {(r[3], r[4]) for r in tables["fast5"]} == {(f"read{i:03d}", s)
                                                       for i in range(2) for s in "tc"}
    assert tables["fast5"] == tables["npRead"]
