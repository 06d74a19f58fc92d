"""Traffic of generative phase-space reconstruction (GPSR): the program's
captured training step (``reconstruction.make_reconstruction_step``) called
back to back, one step a call: the generator's particles, the track through
the configuration's quadrupole scan, the screen's KDE images, the loss on
the target images, its gradient and Adam's step.

Set-up draws the generator's fixed samples and weights, and the truth
generator's (at seed + 1), on the device from the seed, loads the
configuration's lattice through the program's loader, sets the scan and
the screen, computes the target images from the truth generator's beam
through the program's track, and runs the first ``check_steps`` steps
through the window's own call; the reference follows them after the window,
from its own targets."""

from __future__ import annotations

import sys

import torch

from portbench import compare
from portbench.harness import Loop
from portbench.loops.ppo import first_gradient
from portbench.reference import gpsr as reference

SPREADS = ("sigma_x", "sigma_xp", "sigma_y", "sigma_yp", "sigma_s", "sigma_p")


def scan_values(cfg, device):
    """The scan's ``(count,)`` values, evenly spaced as numpy spaces them,
    float32."""
    scan = cfg["scan"]
    n, low, high = scan["count"], scan["low"], scan["high"]
    step = (high - low) / (n - 1)
    return torch.tensor([low + i * step for i in range(n)], dtype=torch.float64,
                        device=device).to(torch.float32)


def draw_generator(cfg, generator, device):
    """``(weights by the program's parameter names, z (N, 6))``: each weight
    and bias from N(0, 1/fan-in), then the fixed normal samples, float32."""
    widths = cfg["generator"]["widths"]
    weights = {}
    for k, (n_in, n_out) in enumerate(zip(widths[:-1], widths[1:])):
        std = n_in ** -0.5
        weights[f"net.{2 * k}.weight"] = torch.randn((n_out, n_in), generator=generator,
                                                     device=device) * std
        weights[f"net.{2 * k}.bias"] = torch.randn(n_out, generator=generator, device=device) * std
    z = torch.randn((cfg["particles"], widths[0]), generator=generator, device=device)
    return weights, z


def image_gap(images, reference_images):
    """The largest absolute pixel gap over the reference's largest pixel."""
    truth = reference_images.double()
    return float(torch.max(torch.abs(images.double() - truth)) / torch.max(torch.abs(truth)))


class GPSR(Loop):
    def setup(self):
        from lynx_tpu_torch.converters.latticejson import load_cheetah_model
        from lynx_tpu_torch.functional import track
        from lynx_tpu_torch.reconstruction import BeamGenerator, make_reconstruction_step

        cfg, traffic, device = self.cfg, self.traffic, self.device
        inputs = self.draw_check_inputs(self.cell, self.seed, device)
        segment = load_cheetah_model(str(self.lattice_path), device=device).subcell(*cfg["cell"])
        scan, screen = cfg["scan"], cfg["screen"]
        for name, value in scan["fixed"].items():
            getattr(segment, name).k1 = torch.tensor(value, device=device)
        reader = getattr(segment, screen["name"])
        reader.is_active, reader.binning = True, screen["binning"]
        reader.method, reader.kde_bandwidth = "kde", screen["kde_bandwidth"]
        spreads = [cfg["beam"][k] for k in SPREADS]

        def beam_generator(weights, z):
            made = BeamGenerator(cfg["particles"], cfg["energy_ev"], spreads,
                                 hidden=cfg["generator"]["widths"][1], device=device)
            with torch.no_grad():
                for name, p in made.named_parameters():
                    p.copy_(weights[name])
                made.z.copy_(z)
            return made

        self.generator = beam_generator(inputs["weights"], inputs["z"])
        truth = beam_generator(inputs["truth_weights"], inputs["truth_z"])
        key = f"{scan['element']}.{scan['field']}"
        with torch.no_grad():
            setattr(getattr(segment, scan["element"]), scan["field"], inputs["k1"])
            targets = track(segment, truth.beam())[1][screen["name"]]
        self.optimizer = torch.optim.Adam(self.generator.parameters(),
                                          lr=cfg["training"]["learning_rate"])
        self.step = make_reconstruction_step(segment, {key: inputs["k1"]}, self.generator,
                                             self.optimizer, targets)
        self.scan_size, self.image_shape = inputs["k1"].shape[0], tuple(targets.shape[-2:])
        start = {n: p.detach().clone() for n, p in self.generator.named_parameters()}
        self.losses = []
        for step in range(traffic["check_steps"]):
            self.call()
            if step == 0:
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                first = {n: first_gradient(self.optimizer, p, beta1)
                         for n, p in self.generator.named_parameters()}
                first_images = self.images.clone()
        change = {n: p.detach() - start[n] for n, p in self.generator.named_parameters()}
        self.program_result = (first_images, ([float(x) for x in self.losses], first, change))
        self.check_inputs = inputs
        self.losses = []
        print(f"KDE particle blocks a call: {self.step.blocks}", file=sys.stderr, flush=True)

    def call(self):
        loss, self.images = self.step()
        self.losses.append(loss.clone())

    def end_to_end(self, window):
        return {"tune_step_ms": window.seconds * 1e3 / window.calls}

    def failed(self):
        if self.losses is None:  # released: counted then
            return self.failures
        return int((~torch.isfinite(torch.stack(self.losses))).sum()) if self.losses else 0

    def captures(self):
        return self.step.cache

    def work(self):
        """``(bytes, flops)``: the KDE's three products (the forward's image
        and the backward's two, ``2 N H W`` each a setting), the particles
        ``(N, 7)`` written and their gradient read, and the images and the
        targets read once.  The exponentials, the maps and the generator's
        arithmetic are left out."""
        height, width = self.image_shape
        n, settings = self.cfg["particles"], self.scan_size
        flops = 3 * 2 * settings * n * height * width
        n_bytes = 4 * (2 * n * 7 + 2 * settings * height * width)
        return n_bytes, flops

    def release(self):
        self.failures = self.failed()
        for name in ("step", "generator", "optimizer", "images", "losses"):
            setattr(self, name, None)

    @staticmethod
    def draw_check_inputs(cell, seed, device):
        """The generator's weights and samples drawn from ``seed``, the truth
        generator's from ``seed + 1``, and the scan's values."""
        cfg = cell.cfg
        generator = torch.Generator(device=device).manual_seed(seed)
        weights, z = draw_generator(cfg, generator, device)
        generator = torch.Generator(device=device).manual_seed(seed + cfg["truth"]["seed_offset"])
        truth_weights, truth_z = draw_generator(cfg, generator, device)
        return {"weights": weights, "z": z, "truth_weights": truth_weights, "truth_z": truth_z,
                "k1": scan_values(cfg, device)}

    @staticmethod
    def reference(cell, inputs, device, dtype=torch.float64, fault=None):
        """``reference.steps``; the faults it knows: ``half_batch`` (half of
        the particles imaged), ``bandwidth`` (twice the bandwidth), ``stale``
        (no Adam step)."""
        traffic = cell.traffic
        return reference.steps(cell.cfg, cell.root, inputs, traffic["check_steps"],
                               cell.cfg["training"]["learning_rate"],
                               traffic["reference_block"], dtype, device, fault=fault)

    @staticmethod
    def judge(result, truth):
        (images, training), (truth_images, truth_training) = result, truth
        detail = {}
        numbers = compare.training(training, truth_training, detail)
        numbers["image_gap"] = image_gap(images, truth_images)
        return numbers, detail


LOOP = GPSR
