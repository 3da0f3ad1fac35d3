"""fast5 (HDF5) 2D-read ingestion: the NanoporeRead-from-fast5 pipeline.

Mirrors scripts/nanoporeLib.py:296-660: dragonet 1.15.0/1.19.0 path layouts,
alignment-table sequence reconstruction (:359-392), twoD event-map
construction with gap heuristics (:423-514), drift correction (:516-531),
model-adjustment (scale/shift/var/...) extraction (:559-590), and pore-model
export with lambda = noise_mean^3 / noise_sd^2 and the hardcoded 30
skip-probability bins (:592-655).

h5py is imported lazily so the rest of the package works without HDF5 data.

Copied from ``cpecan_signal_tpu/io/fast5.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from ..constants import NB_EVENT_PARAMS
from .npread import NanoporeRead, ScaleParams

TEMPLATE_SKIP_BINS = [0.487, 0.412, 0.311, 0.229, 0.174, 0.134, 0.115, 0.103,
                      0.096, 0.092, 0.088, 0.087, 0.084, 0.085, 0.083, 0.082,
                      0.085, 0.083, 0.084, 0.082, 0.080, 0.085, 0.088, 0.086,
                      0.087, 0.089, 0.085, 0.090, 0.087, 0.096]
COMPLEMENT_SKIP_BINS = [0.531, 0.478, 0.405, 0.327, 0.257, 0.207, 0.172, 0.154,
                        0.138, 0.132, 0.127, 0.123, 0.117, 0.115, 0.113, 0.113,
                        0.115, 0.109, 0.109, 0.107, 0.104, 0.105, 0.108, 0.106,
                        0.111, 0.114, 0.118, 0.119, 0.110, 0.119]

_2D_BASE = "/Analyses/Basecall_2D_000"
_ALIGNMENT = _2D_BASE + "/BaseCalled_2D/Alignment"
_FASTQ = _2D_BASE + "/BaseCalled_2D/Fastq"


class Fast5Read:
    """A 2D nanopore read loaded from a fast5 file."""

    def __init__(self, path: str):
        import h5py

        self.path = path
        self.f = h5py.File(path, "r")
        version = self.f[_2D_BASE].attrs["dragonet version"]
        if isinstance(version, bytes):
            version = version.decode()
        if version == "1.15.0":
            base = _2D_BASE
        elif version == "1.19.0":
            base = "/Analyses/Basecall_1D_000"
        else:
            raise ValueError(f"unsupported dragonet version {version!r} "
                             "(1.15.0 and 1.19.0 supported)")
        self.template_events_addr = base + "/BaseCalled_template/Events"
        self.template_model_addr = base + "/BaseCalled_template/Model"
        self.complement_events_addr = base + "/BaseCalled_complement/Events"
        self.complement_model_addr = base + "/BaseCalled_complement/Model"

        self.alignment_table = self.f[_ALIGNMENT][()]
        self.kmer_length = len(self._kmer(0))

    def _kmer(self, row: int) -> str:
        k = self.alignment_table[row][2]
        return k.decode() if isinstance(k, bytes) else k

    def alignment_table_sequence(self) -> str:
        """Sequence reconstructed from the 2D alignment table (every position
        is guaranteed an event mapping; get_alignment_sequence,
        nanoporeLib.py:359-392)."""

        def overlap(ki, kj):
            for i in range(1, len(ki)):
                if ki[i:] == kj[:-i]:
                    return i
            return len(ki)

        seq = self._kmer(0)
        p_kmer = self._kmer(0)
        for row in range(len(self.alignment_table)):
            kmer = self._kmer(row)
            if kmer != p_kmer:
                i = overlap(p_kmer, kmer)
                seq += kmer[-i:]
                p_kmer = kmer
        return seq

    def twoD_event_map(self, seq: str) -> tuple[list[int], list[int]]:
        """kmer -> (template event, complement event) maps with the reference's
        gap heuristics (get_twoD_event_map, nanoporeLib.py:423-514)."""
        k = self.kmer_length
        t_map: list[int] = []
        c_map: list[int] = []
        row = 0
        prev_kmer = ""
        nb_t_gaps = 0
        prev_c = None
        prev_t = None
        n_kmers = len(seq) - k + 1
        for i in range(n_kmers):
            seq_kmer = seq[i:i + k]
            cur = self._kmer(row)
            while cur == prev_kmer:
                row += 1
                cur = self._kmer(row)
            if seq_kmer == cur:
                t_ev = int(self.alignment_table[row][0])
                c_ev = int(self.alignment_table[row][1])
                if t_ev == -1:
                    nb_t_gaps += 1
                else:
                    if nb_t_gaps == 0:
                        t_map.append(t_ev)
                    else:
                        t_map.extend([t_ev] * (nb_t_gaps + 1))
                        nb_t_gaps = 0
                    prev_t = t_ev
                if c_ev == -1:
                    c_map.append(prev_c)
                else:
                    c_map.append(c_ev)
                    prev_c = c_ev
                prev_kmer = cur
                row += 1
            else:
                t_map.append(prev_t)
                c_map.append(prev_c)
        # final events for the partial last kmer
        for _ in range(k - 1):
            t_map.extend([prev_t] * (nb_t_gaps + 1))
            nb_t_gaps = 0
            c_map.append(prev_c)
        assert len(t_map) == len(seq), (len(t_map), len(seq))
        assert len(c_map) == len(seq)
        t_map = [0 if v is None else v for v in t_map]
        c_map = [0 if v is None else v for v in c_map]
        return t_map, c_map

    def _events(self, addr: str, drift: float) -> np.ndarray:
        """(mean, noise, duration) triples with drift correction
        (transform_events, nanoporeLib.py:516-531)."""
        table = self.f[addr][()]
        mean = np.asarray(table["mean"], dtype=np.float64)
        start = np.asarray(table["start"], dtype=np.float64)
        stdv = np.asarray(table["stdv"], dtype=np.float64)
        length = np.asarray(table["length"], dtype=np.float64)
        mean = mean - (start - start[0]) * drift
        return np.stack([mean, stdv, length], axis=1)

    def _scale_params(self, addr: str) -> tuple[ScaleParams, float]:
        a = self.f[addr].attrs
        return (ScaleParams(float(a["scale"]), float(a["shift"]), float(a["var"]),
                            float(a["scale_sd"]), float(a["var_sd"])),
                float(a["drift"]))

    def to_npread(self) -> NanoporeRead:
        seq = self.alignment_table_sequence()
        t_map, c_map = self.twoD_event_map(seq)
        t_params, t_drift = self._scale_params(self.template_model_addr)
        c_params, c_drift = self._scale_params(self.complement_model_addr)
        t_events = self._events(self.template_events_addr, t_drift)
        c_events = self._events(self.complement_events_addr, c_drift)
        return NanoporeRead(
            read_length=len(seq), twoD_read=seq,
            template_params=t_params, complement_params=c_params,
            template_event_map=np.asarray(t_map, dtype=np.int64),
            template_events=t_events,
            complement_event_map=np.asarray(c_map, dtype=np.int64),
            complement_events=c_events)

    def export_model(self, strand: str, destination) -> bool:
        """Write the onboard pore model in the 3-line format (export_model,
        nanoporeLib.py:592-655); the Y model's level_sd is scaled x1.75."""
        addr = (self.template_model_addr if strand == "template"
                else self.complement_model_addr)
        bins = (TEMPLATE_SKIP_BINS if strand == "template"
                else COMPLEMENT_SKIP_BINS)
        if addr not in self.f:
            return False
        model = self.f[addr][()]
        lams = []
        parts = ["0"]
        for row in model:
            level_mean, level_sd, noise_mean, noise_sd = (
                float(row["level_mean"]), float(row["level_stdv"]),
                float(row["sd_mean"]), float(row["sd_stdv"]))
            lam = noise_mean**3 / noise_sd**2
            lams.append(lam)
            parts += [str(level_mean), str(level_sd), str(noise_mean),
                      str(noise_sd), str(lam)]
        destination.write(" ".join(parts) + " \n")
        destination.write(" ".join(str(p) for p in bins) + " \n")
        parts = ["0"]
        for row, lam in zip(model, lams):
            parts += [str(float(row["level_mean"])),
                      str(float(row["level_stdv"]) * 1.75),
                      str(float(row["sd_mean"])), str(float(row["sd_stdv"])),
                      str(lam)]
        destination.write(" ".join(parts) + " \n")
        return True

    def close(self):
        self.f.close()


def fast5_to_npread(path: str) -> NanoporeRead:
    """Standalone converter (fast5_to_npRead.py equivalent)."""
    read = Fast5Read(path)
    try:
        return read.to_npread()
    finally:
        read.close()
