"""Traffic of six-dimensional generative phase-space reconstruction: the
program's captured training step (``reconstruction.make_reconstruction_step``
with two measurements) called back to back, one step a call: the
generator's particles, the line before the spectrometer dipole tracked once
for the shared settings (the quadrupole scan with the transverse deflecting
cavities off and on), each screen's tail tracked for its own settings (the
dipole off to the straight screen, on to the bent one), both screens' KDE
images, the loss over both, its gradient and Adam's step.

Set-up draws the generator's fixed samples and weights, and the truth
generator's (at seed + 1), on the device from the seed, loads the
configuration's lattice through the program's loader, puts the program's
``TransverseDeflectingCavity`` in place of the file's two deflecting
structures, sets the scan and the screens, computes the target images from
the truth generator's beam through the program's track, and runs the first
``check_steps`` steps through the window's own call; the reference
(``reference/gpsr6d.py``) follows them after the window, from its own
targets."""

from __future__ import annotations

import sys

import torch

from portbench import compare
from portbench.harness import Loop
from portbench.loops.gpsr import SPREADS, draw_generator, image_gap, scan_values
from portbench.loops.ppo import first_gradient
from portbench.reference import gpsr6d as reference


def dogleg(cfg, lattice_path, device, dtype=torch.float32):
    """The configuration's cell loaded through the program's loader, the
    configuration's TDS elements replaced by the program's
    ``TransverseDeflectingCavity`` (the file's length and frequency, the
    configuration's phase, 0 V), the fixed quadrupoles set and both screens
    reading KDE images, neither active (each measurement reads its own)."""
    from lynx_tpu_torch.accelerator import Segment, TransverseDeflectingCavity
    from lynx_tpu_torch.converters.latticejson import load_cheetah_model

    tds, screens = cfg["tds"], cfg["screens"]

    def replaced(element):
        if element.name not in tds["elements"]:
            return element
        return TransverseDeflectingCavity(element.length, voltage=0.0, phase=tds["phase"],
                                          frequency=element.frequency, name=element.name,
                                          dtype=dtype, device=device)

    cell = load_cheetah_model(str(lattice_path), dtype, device).subcell(*cfg["cell"])
    segment = Segment([replaced(e) for e in cell.elements], name=cell.name)
    for name, value in cfg["scan"]["fixed"].items():
        getattr(segment, name).k1 = torch.tensor(value, dtype=dtype, device=device)
    for name in (screens["straight"], screens["bent"]):
        reader = getattr(segment, name)
        reader.is_active, reader.binning = False, screens["binning"]
        reader.method, reader.kde_bandwidth = "kde", screens["kde_bandwidth"]
    return segment


def beam_generator(cfg, weights, z, device, dtype=torch.float32):
    """The program's ``BeamGenerator`` with ``weights`` and samples ``z``."""
    from lynx_tpu_torch.reconstruction import BeamGenerator

    made = BeamGenerator(cfg["particles"], cfg["energy_ev"], [cfg["beam"][k] for k in SPREADS],
                         hidden=cfg["generator"]["widths"][1], dtype=dtype, device=device)
    with torch.no_grad():
        for name, p in made.named_parameters():
            p.copy_(weights[name])
        made.z.copy_(z)
    return made


def measurements(cfg, k1, voltage):
    """``{screen: scan values}`` of the two measurements: the shared
    settings' ``k1`` and each TDS's ``voltage`` (one tensor each, shared by
    both), the dipole off for the straight screen and on for the bent one."""
    tds, dipole, screens = cfg["tds"], cfg["dipole"], cfg["screens"]
    shared = {f"{cfg['scan']['element']}.{cfg['scan']['field']}": k1}
    shared.update({f"{name}.voltage": voltage for name in tds["elements"]})
    angle = f"{dipole['element']}.angle"
    return {screens["straight"]: dict(shared, **{angle: torch.zeros_like(k1)}),
            screens["bent"]: dict(shared, **{angle: torch.full_like(k1, dipole["angle"])})}


def scanned(segment, values, screen):
    """``segment`` as the measurement on ``screen`` runs it: its scanned
    fields set, ``screen`` read and every other screen passed."""
    from lynx_tpu_torch.accelerator import Screen, Segment

    fields = {}
    for key, value in values.items():
        name, field = key.rsplit(".", 1)
        fields.setdefault(name, {})[field] = value
    out = []
    for element in segment.elements:
        updates = dict(fields.get(element.name, {}))
        if isinstance(element, Screen):
            updates["is_active"] = element.name == screen
        out.append(element.replace(**updates) if updates else element)
    return Segment(out)


def imaged(segment, truth, by_screen):
    """The measurements ``[reconstruction.Measurement]`` of ``by_screen``
    (``{screen: scan values}``), their targets the images of ``truth``'s
    beam through the program's track."""
    from lynx_tpu_torch.functional import track
    from lynx_tpu_torch.reconstruction import Measurement

    with torch.no_grad():
        beam = truth.beam()
        return [Measurement(values, screen,
                            track(scanned(segment, values, screen), beam)[1][screen])
                for screen, values in by_screen.items()]


class GPSR6D(Loop):
    def setup(self):
        from lynx_tpu_torch.reconstruction import make_reconstruction_step

        cfg, traffic, device = self.cfg, self.traffic, self.device
        inputs = self.draw_check_inputs(self.cell, self.seed, device)
        segment = dogleg(cfg, self.lattice_path, device)
        self.generator = beam_generator(cfg, inputs["weights"], inputs["z"], device)
        truth = beam_generator(cfg, inputs["truth_weights"], inputs["truth_z"], device)
        k1, voltage = reference.settings(cfg, inputs["k1"], torch.float32, device)
        self.measured = imaged(segment, truth, measurements(cfg, k1, voltage))
        self.optimizer = torch.optim.Adam(self.generator.parameters(),
                                          lr=cfg["training"]["learning_rate"])
        self.step = make_reconstruction_step(segment, self.measured, self.generator,
                                             self.optimizer)
        self.image_shapes = [tuple(m.targets.shape) for m in self.measured]
        start = {n: p.detach().clone() for n, p in self.generator.named_parameters()}
        self.losses = []
        for step in range(traffic["check_steps"]):
            self.call()
            if step == 0:
                beta1 = self.optimizer.param_groups[0]["betas"][0]
                first = {n: first_gradient(self.optimizer, p, beta1)
                         for n, p in self.generator.named_parameters()}
                first_images = tuple(i.clone() for i in self.images)
        change = {n: p.detach() - start[n] for n, p in self.generator.named_parameters()}
        self.program_result = (first_images, ([float(x) for x in self.losses], first, change))
        self.check_inputs = inputs
        self.losses = []
        print(f"images a step by screen: {self.step.images}; B9 launches a step:"
              f" {self.step.launches}; KDE particle blocks a call: {self.step.blocks}",
              file=sys.stderr, flush=True)

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
        and the backward's two, ``2 N H W`` each an image) on both screens'
        images, the particles ``(N, 7)`` written and their gradient read,
        and the images and the targets read once.  The exponentials, the
        maps and the generator's arithmetic are left out."""
        n = self.cfg["particles"]
        pixels = sum(s * h * w for s, h, w in self.image_shapes)
        return 4 * (2 * n * 7 + 2 * pixels), 3 * 2 * n * pixels

    def release(self):
        self.failures = self.failed()
        for name in ("step", "generator", "optimizer", "images", "losses", "measured"):
            setattr(self, name, None)

    @staticmethod
    def draw_check_inputs(cell, seed, device):
        """The generator's weights and samples drawn from ``seed``, the truth
        generator's from ``seed + 1``, and the scan's values (the shared
        settings are them with the TDS off, then on: ``reference.settings``)."""
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
        the particles imaged), ``stale`` (no Adam step), ``no_p_row`` (the
        TDS leaves ``p`` as it is), ``swapped`` (each screen imaged on the
        other screen's settings)."""
        traffic = cell.traffic
        return reference.steps(cell.cfg, cell.root, inputs, traffic["check_steps"],
                               cell.cfg["training"]["learning_rate"],
                               traffic["reference_block"], dtype, device, fault=fault)

    @staticmethod
    def judge(result, truth):
        (images, training), (truth_images, truth_training) = result, truth
        detail = {}
        numbers = compare.training(training, truth_training, detail)
        gaps = [image_gap(i, t) for i, t in zip(images, truth_images)]
        detail["image_gaps"] = gaps
        numbers["image_gap"] = max(gaps)
        return numbers, detail


LOOP = GPSR6D
