"""npRead file parsing: the 6-line text format produced by the fast5 pipeline.

Format (nanopore_loadNanoporeReadFromFile, nanopore.c:40-200):
  line 1: readLength #templateEvents #complementEvents
          t.scale t.shift t.var t.scale_sd t.var_sd
          c.scale c.shift c.var c.scale_sd c.var_sd
  line 2: 2D read sequence
  line 3: template event map (readLength ints: kmer index -> event index)
  line 4: template events (mean, noise, duration) x nbTemplateEvents
  line 5: complement event map
  line 6: complement events

Copied from ``cpecan_signal_tpu/io/npread.py`` with its imports made relative
to the port, so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import NB_EVENT_PARAMS


@dataclass
class ScaleParams:
    """Read-specific model adjustment parameters (nanopore.h:14-21)."""

    scale: float
    shift: float
    var: float
    scale_sd: float
    var_sd: float


@dataclass
class NanoporeRead:
    read_length: int
    twoD_read: str
    template_params: ScaleParams
    complement_params: ScaleParams
    template_event_map: np.ndarray    # (read_length,) int64
    template_events: np.ndarray       # (n_t, 3) float64 (mean, noise, duration)
    complement_event_map: np.ndarray
    complement_events: np.ndarray

    def descale(self) -> "NanoporeRead":
        """Return a copy with event means descaled: (mean - shift) / scale
        (nanopore_descaleNanoporeRead, nanopore.c:228-236)."""
        t = self.template_events.copy()
        c = self.complement_events.copy()
        t[:, 0] = (t[:, 0] - self.template_params.shift) / self.template_params.scale
        c[:, 0] = (c[:, 0] - self.complement_params.shift) / self.complement_params.scale
        return NanoporeRead(self.read_length, self.twoD_read, self.template_params,
                            self.complement_params, self.template_event_map, t,
                            self.complement_event_map, c)


def load_npread(path: str) -> NanoporeRead:
    with open(path) as fh:
        header = fh.readline().split()
        read_len, n_t, n_c = (int(v) for v in header[:3])
        tp = ScaleParams(*(float(v) for v in header[3:8]))
        cp = ScaleParams(*(float(v) for v in header[8:13]))
        seq = fh.readline().strip()
        t_map = np.asarray(fh.readline().split(), dtype=np.int64)
        t_events = np.asarray(fh.readline().split(), dtype=np.float64)
        c_map = np.asarray(fh.readline().split(), dtype=np.int64)
        c_events = np.asarray(fh.readline().split(), dtype=np.float64)
    if len(seq) != read_len:
        raise ValueError(f"npRead 2D sequence length {len(seq)} != header {read_len}")
    if len(t_map) != read_len or len(c_map) != read_len:
        raise ValueError("npRead event map length mismatch")
    if len(t_events) != n_t * NB_EVENT_PARAMS or len(c_events) != n_c * NB_EVENT_PARAMS:
        raise ValueError("npRead event array length mismatch")
    return NanoporeRead(
        read_length=read_len,
        twoD_read=seq,
        template_params=tp,
        complement_params=cp,
        template_event_map=t_map,
        template_events=t_events.reshape(n_t, NB_EVENT_PARAMS),
        complement_event_map=c_map,
        complement_events=c_events.reshape(n_c, NB_EVENT_PARAMS),
    )


def write_npread(path: str, npr: NanoporeRead) -> None:
    """Inverse of load_npread (the format written by get_npRead_2dseq_and_models,
    scripts/nanoporeLib.py:54-152)."""
    with open(path, "w") as fh:
        tp, cp = npr.template_params, npr.complement_params
        head = [npr.read_length, len(npr.template_events), len(npr.complement_events),
                tp.scale, tp.shift, tp.var, tp.scale_sd, tp.var_sd,
                cp.scale, cp.shift, cp.var, cp.scale_sd, cp.var_sd]
        fh.write(" ".join(str(v) for v in head) + "\n")
        fh.write(npr.twoD_read + "\n")
        fh.write(" ".join(str(int(v)) for v in npr.template_event_map) + "\n")
        fh.write(" ".join(repr(float(v)) for v in npr.template_events.ravel()) + "\n")
        fh.write(" ".join(str(int(v)) for v in npr.complement_event_map) + "\n")
        fh.write(" ".join(repr(float(v)) for v in npr.complement_events.ravel()) + "\n")
