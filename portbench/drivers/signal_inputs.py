"""What the signal cells share: the inputs drawn from the seed, and their
hand-over to the program in the program's own types."""

from __future__ import annotations

import numpy as np

from portbench.gen import signal as gen


def draw(config: dict, traffic: dict, seed: int, n_reads: int) -> dict:
    """Pore models, reference and the read pool of a run, from the seed."""
    rng = np.random.default_rng([seed, 1])
    models = [gen.pore_model(rng), gen.pore_model(rng)]     # template, complement
    ref = gen.random_codes(rng, int(config["reference_bases"]))
    mix = traffic["read_lengths"]
    lengths = gen.read_lengths(n_reads, mix["median"], mix["sigma"], mix["min"], mix["max"])
    reads = gen.read_pool(ref, models, rng, lengths, tuple(traffic["substitutions"]),
                          tuple(traffic["indels"]))
    return {"models": models, "ref": ref, "reads": reads}


def n_events(read: dict) -> int:
    return len(read["t_events"]) + len(read["c_events"])


class Program:
    """The inputs in the program's types: pore models, reads, guides."""

    def __init__(self, inputs: dict, config: dict):
        from cpecan_signal_tpu_torch.io.cigar import CigarRecord
        from cpecan_signal_tpu_torch.io.npread import NanoporeRead, ScaleParams
        from cpecan_signal_tpu_torch.models.params import cli_defaults
        from cpecan_signal_tpu_torch.models.pore_model import PoreModel

        s = config["settings"]
        self.params = cli_defaults().with_(
            diagonal_expansion=s["diagonal_expansion"],
            constraint_diagonal_trim=s["constraint_trim"], threshold=s["threshold"],
            split_matrix_bigger_than_this=s["split_matrix_bigger_than_this"])
        pad = np.zeros((2, 5))
        self.models = [PoreModel(0.0, np.concatenate([m, pad]), 0.0,
                                 np.concatenate([m, pad]), np.full(60, 0.1))
                       for m in inputs["models"]]
        self.ref = gen.to_str(inputs["ref"])
        unit = ScaleParams(1.0, 0.0, 1.0, 1.0, 1.0)
        self.reads, self.guides = [], []
        for r in inputs["reads"]:
            g = r["guide"]
            self.reads.append(NanoporeRead(len(r["seq"]), gen.to_str(r["seq"]), unit, unit,
                                           r["t_map"], r["t_events"], r["c_map"],
                                           r["c_events"]))
            self.guides.append(CigarRecord("ref", g["start1"], g["end1"], g["strand1"],
                                           "read", g["start2"], g["end2"], True, 0.0,
                                           list(g["ops"])))

    def prepare(self, i: int) -> dict:
        """``cli/vanilla_align.prepare_read`` of read i with its guide."""
        from cpecan_signal_tpu_torch.cli.vanilla_align import prepare_read

        return prepare_read(self.ref, self.reads[i], self.params, sm_type="threeState",
                            guide=self.guides[i], substitute=None,
                            template_model=self.models[0], complement_model=self.models[1])
