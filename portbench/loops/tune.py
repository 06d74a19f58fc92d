"""Traffic of gradient tuning: the program's captured tuner
(``tuning.make_tuner`` with Adam) on B settings of every tuned field of the
configuration's line, one step a call, the loss the sum over the settings
of |mu_x| + sigma_x + |mu_y| + sigma_y of a Gaussian beam at the line's end:
the L1 distance of the beam's four parameters from a centred beam of zero
size, the form of the ARES-EA task's objective (Kaiser et al., ICML 2022),
so that every tuned field, the correctors' angles too, has a gradient.

Set-up loads the configuration's lattice file through the program's loader,
draws each field's B values on the device from the seed (``fields`` in the
traffic file: a quadrupole's |k1| uniform in a range with a random sign, a
corrector's angle, a solenoid's k uniform in a range, a dipole's angle its
file value plus a uniform offset), and runs the first ``check_steps`` steps
through the window's own call; the reference follows them after the window."""

from __future__ import annotations

import torch

from portbench import compare, roofline
from portbench.harness import Loop
from portbench.loops.ppo import first_gradient
from portbench.reference import lattice as lat
from portbench.reference import optics
from portbench.reference import tune as reference


def loss_of(outgoing):
    return torch.sum(outgoing.mu_x.abs() + outgoing.sigma_x + outgoing.mu_y.abs()
                     + outgoing.sigma_y)


def draw(kind, fields, draws, B, generator, device):
    """B values of a tuned element's field, float32 on ``device``."""
    rule = draws[kind]
    u = torch.rand(B, generator=generator, device=device)
    low, high = rule["range"]
    value = low + (high - low) * u
    if rule.get("either_sign"):
        sign = torch.rand(B, generator=generator, device=device) < 0.5
        value = torch.where(sign, -value, value)
    if rule.get("offset_from_file"):
        value = value + lat.scalar(fields, lat.TUNED_FIELD[kind])
    return value


def reference_elements(cfg, path):
    elements = lat.load(path)
    return lat.cell(elements, *cfg["cell"]) if "cell" in cfg else elements


def beam_moments(cfg, B, device):
    """The configured Gaussian beam's ``(mu, cov)`` for B settings, float32."""
    beam = cfg["beam"]
    spread = torch.tensor([beam["sigma_x"], beam["sigma_xp"], beam["sigma_y"],
                           beam["sigma_yp"]], device=device).expand(B, 4)
    return optics.gaussian(torch.zeros((B, 4), device=device), spread, beam["sigma_s"],
                           beam["sigma_p"], torch.float32, device)


def tuned_slots(elements, draws):
    """The tuned elements' ``(index, name, field)``, in lattice order."""
    return [(i, name, lat.TUNED_FIELD[kind]) for i, (name, kind, _) in enumerate(elements)
            if kind in draws]


def draw_fields(elements, draws, B, generator, device):
    """The tuned fields' ``(B, n)`` values drawn from ``generator``, in
    lattice order."""
    return torch.stack([draw(elements[i][1], elements[i][2], draws, B, generator, device)
                        for i, _, _ in tuned_slots(elements, draws)], dim=1)


class Tune(Loop):
    def setup(self):
        from lynx_tpu_torch import functional, graphs, tuning
        from lynx_tpu_torch.converters.latticejson import load_cheetah_model
        from lynx_tpu_torch.particles import ParameterBeam

        cfg, traffic, device = self.cfg, self.traffic, self.device
        self.batch = traffic["settings"]
        lattice = load_cheetah_model(str(self.lattice_path), device=device)
        if "cell" in cfg:
            lattice = lattice.subcell(*cfg["cell"])
        self.elements = reference_elements(cfg, self.lattice_path)
        if [e.name for e in lattice.elements] != [name for name, _, _ in self.elements]:
            raise ValueError("the program's lattice and the reference's differ in their elements")
        self.slots = tuned_slots(self.elements, traffic["fields"])
        inputs = self.draw_check_inputs(self.cell, self.seed, device)
        self.params = [v.clone().requires_grad_(True) for v in inputs["start"].unbind(1)]
        energy = torch.full((1,), cfg["energy_ev"], device=device)
        self.beam = ParameterBeam(inputs["mu"], inputs["cov"], energy)
        self.lattice = lattice
        slots = self.slots

        def loss_fn(params, segment, incoming):
            for (i, _, name), value in zip(slots, params):
                setattr(segment.elements[i], name, value)
            return loss_of(functional.track(segment, incoming)[0])

        self.optimizer = torch.optim.Adam(self.params, lr=traffic["learning_rate"])
        before = set(graphs._CACHES)
        self.tuner = tuning.make_tuner(self.optimizer, loss_fn)
        # make_tuner keeps its step cache to itself: take the one it added.
        self.cache = next(iter(set(graphs._CACHES) - before), None)
        self.histories = []
        for step in range(traffic["check_steps"]):
            self.call()
            if step == 0:
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                first = torch.stack([first_gradient(self.optimizer, p, beta1)
                                     for p in self.params], dim=1)
        losses = [float(h[0]) for h in self.histories]
        change = torch.stack([p.detach() for p in self.params], dim=1) - inputs["start"]
        names = [name for _, name, _ in self.slots]
        self.program_result = (losses, compare.columns(first, names),
                               compare.columns(change, names))
        self.check_inputs = inputs
        self.histories = []

    def call(self):
        self.histories.append(self.tuner(self.params, 1, self.lattice, self.beam)[1])

    def end_to_end(self, window):
        return {"tune_step_ms": window.seconds * 1e3 / window.calls}

    def failed(self):
        if self.histories is None:  # released: counted then
            return self.failures
        return int((~torch.isfinite(torch.cat(self.histories))).sum()) if self.histories else 0

    def captures(self):
        return self.cache

    def work(self):
        line = optics.Line(self.elements, self.cfg["energy_ev"],
                           {name: k for k, (_, name, _) in enumerate(self.slots)},
                           torch.float64, "cpu")
        return roofline.tune_work(line, self.batch, len(self.slots))

    def release(self):
        self.failures = self.failed()
        for name in ("tuner", "optimizer", "params", "lattice", "beam", "histories", "cache"):
            setattr(self, name, None)

    @staticmethod
    def draw_check_inputs(cell, seed, device):
        """The settings' starting fields ``(B, n)`` and the beam's moments,
        drawn from ``seed``."""
        generator = torch.Generator(device=device).manual_seed(seed)
        elements = reference_elements(cell.cfg, cell.root / cell.cfg["lattice"])
        B = cell.traffic["settings"]
        start = draw_fields(elements, cell.traffic["fields"], B, generator, device)
        mu, cov = beam_moments(cell.cfg, B, device)
        return {"start": start, "mu": mu, "cov": cov}

    @staticmethod
    def reference(cell, inputs, device, dtype=torch.float64, fault=None):
        """``reference.steps`` through the plain line; ``fault="half_batch"``
        its loss over half of the settings."""
        cfg, traffic = cell.cfg, cell.traffic
        elements = reference_elements(cfg, cell.root / cfg["lattice"])
        names = [name for _, name, _ in tuned_slots(elements, traffic["fields"])]
        line = optics.Line(elements, cfg["energy_ev"], {n: k for k, n in enumerate(names)},
                           dtype, device)
        losses, first, change = reference.steps(
            line, *(inputs[k].to(dtype) for k in ("start", "mu", "cov")),
            traffic["check_steps"], traffic["learning_rate"], traffic["reference_block"],
            fault=fault)
        return losses, compare.columns(first, names), compare.columns(change, names)

    @staticmethod
    def judge(result, truth):
        detail = {}
        return compare.training(result, truth, detail), detail


LOOP = Tune
