"""Traffic of a virtual-diagnostic client: one client in a closed loop, each
call setting new k1 on the configuration's screen-read quadrupoles (uniform
within ``k1_spread`` of the configured working point, drawn from the seed),
replaying the program's ``functional.track_jit`` of the particle beam and
waiting until the screen's image is complete on the device.

A seeded reservoir keeps ``sample`` of the window's images, drawn uniformly
over all its calls; the reference images them after the window."""

from __future__ import annotations

import random

import torch

from portbench import compare, roofline
from portbench.harness import Loop, percentile
from portbench.reference import lattice as lat
from portbench.reference import optics
from portbench.reference.precision import matmul

POOL = 1 << 16  # k1 draws made at set-up; call i takes draw i mod POOL


def draw_particles(beam, n, batch, generator, device):
    """``(batch, n, 7)`` float32 particles of uncorrelated Gaussian planes."""
    spread = torch.tensor([beam[k] for k in ("sigma_x", "sigma_xp", "sigma_y", "sigma_yp",
                                             "sigma_s", "sigma_p")], device=device)
    coords = torch.randn((batch, n, 6), generator=generator, device=device) * spread
    return torch.cat([coords, torch.ones((batch, n, 1), device=device)], dim=-1)


def draw_inputs(cell, seed, device):
    """``(generator, k1 pool (POOL, batch, quads), particles (batch, N, 7))``."""
    cfg, batch = cell.cfg, cell.traffic["batch"]
    generator = torch.Generator(device=device).manual_seed(seed)
    quads = cfg["screen_read"]["k1"]
    working = torch.tensor(list(quads.values()), device=device)
    u = torch.rand((POOL, batch, len(quads)), generator=generator, device=device)
    k1 = working * (1 + cell.traffic["k1_spread"] * (2 * u - 1))
    return generator, k1, draw_particles(cfg["beam"], cfg["particles"], batch, generator, device)


class Screen(Loop):
    in_flight = None  # the client waits for each image

    def setup(self):
        from lynx_tpu_torch import functional
        from lynx_tpu_torch.models import ares_ea_segment
        from lynx_tpu_torch.particles import ParticleBeam

        cfg, traffic, device = self.cfg, self.traffic, self.device
        batch = self.units_per_call = traffic["batch"]
        self.quads = list(cfg["screen_read"]["k1"])
        _, self.k1, self.particles = draw_inputs(self.cell, self.seed, device)
        self.segment = ares_ea_segment(device=device)
        if batch > 1:
            self.segment = self.segment.broadcast((batch,))
        self.screen = cfg["screen_read"]["screen"]
        getattr(self.segment, self.screen).is_active = True
        self.beam = ParticleBeam(self.particles,
                                 torch.full((batch,), cfg["energy_ev"], device=device))
        self.track = functional.track_jit
        self.index = 0
        self.sampler = random.Random(self.seed)
        self.sample = []  # (call, k1 row, image)
        for _ in range(traffic["warm_calls"]):
            self.call()
            self.wait()
        self.index, self.sample = 0, []

    def call(self):
        row = self.index % POOL
        for j, name in enumerate(self.quads):
            getattr(self.segment, name).k1 = self.k1[row, :, j]
        self.image = self.track(self.segment, self.beam)[1][self.screen]
        kept = self.traffic["sample"]
        if len(self.sample) < kept:
            self.sample.append((self.index, row, self.image))
        else:
            slot = self.sampler.randrange(self.index + 1)
            if slot < kept:
                self.sample[slot] = (self.index, row, self.image)
        self.index += 1

    def wait(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def end_to_end(self, window):
        return {"images_per_s": window.calls * self.units_per_call / window.seconds,
                "image_ms_p95": percentile(window.latency, 95) * 1e3}

    def failed(self):
        return getattr(self, "failures", 0)

    def captures(self):
        return self.track.graphed

    def work(self):
        return roofline.read_work(self.cfg, self.lattice_path, self.units_per_call,
                                  self.particles.element_size())

    def release(self):
        from lynx_tpu_torch.ops.histogram import histogram_fallback_count

        self.fallbacks = histogram_fallback_count()
        self.program_result = [image.detach() for _, _, image in self.sample]
        self.check_inputs = {"k1": torch.stack([self.k1[row] for _, row, _ in self.sample]),
                             "particles": self.particles}
        for name in ("segment", "beam", "track", "image", "k1", "sample"):
            setattr(self, name, None)

    @staticmethod
    def draw_check_inputs(cell, seed, device):
        """``sample`` k1 rows of the pool, drawn from ``seed``, and the
        particles."""
        _, k1, particles = draw_inputs(cell, seed, device)
        rows = random.Random(seed).sample(range(POOL), cell.traffic["sample"])
        return {"k1": k1[rows], "particles": particles}

    @staticmethod
    def reference(cell, inputs, device, dtype=torch.float64, fault=None):
        """The images ``(batch, H, W)`` of each k1 row of ``inputs``, the
        particles pushed through the plain line in ``dtype``;
        ``fault="half_batch"`` images half of the particles and doubles the
        counts."""
        cfg = cell.cfg
        read = cfg["screen_read"]
        elements = lat.cell(lat.load(cell.root / cfg["lattice"]), *cfg["cell"])
        fields = elements[[name for name, _, _ in elements].index(read["screen"])][2]
        line = optics.Line(elements, cfg["energy_ev"],
                           {name: j for j, name in enumerate(read["k1"])}, dtype, device)
        particles = inputs["particles"].to(dtype)
        scale = 1
        if fault == "half_batch":
            particles, scale = particles[:, :particles.shape[1] // 2], 2
        out = []
        for k1 in inputs["k1"].to(dtype):
            images = []
            for b in range(particles.shape[0]):
                pushed = matmul(particles[b], line.total(k1[b:b + 1])[0].transpose(0, 1))
                images.append(optics.screen_image(pushed[:, 0], pushed[:, 2], fields))
            out.append(scale * torch.stack(images))
        return out

    @staticmethod
    def judge(result, truth):
        moved = [compare.moved(image, reference) for image, reference in zip(result, truth)]
        return {"moved_particles": max(moved)}, {"moved": moved}

    def check(self):
        numbers = super().check()
        self.failures = sum(m > self.cell.limits["moved_particles"] for m in self.detail["moved"])
        return numbers


LOOP = Screen
