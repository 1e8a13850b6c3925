"""The plain reference of one simulation update, and its control one precision lower.

Built from the configuration and the cascade specs (`core.spec`) alone: the
spectra come from the frozen oracle (`oracle.py`, NumPy fp32, the GLSL's
own arithmetic), omega is the oracle's dispersion on its fp32 k-grid, and
each cascade's time follows the stated semantics, fp32 from 120 + pi i
advancing by fp32 dt before each update. From there `step` works in
float64: the phase is the fp32 product omega * t the shaders form, its
cosine and sine and everything after in double precision, the 2D inverse
transform by `torch.fft` in complex128, laid out as the oracle's
rows -> transpose -> rows chain leaves it (N^2 ifft2, transposed), then the
ifftshift sign, the unpack and the persistent foam.

`control_step` is the same update one step below each precision that the
configuration states: the layers and the transform's intermediate rounded
to bfloat16 (an fp32 core stated), and the maps rounded to fp8 e4m3 (bf16
maps stated). The benchmark never runs it; its tests and `calibrate.py` do,
to show that the comparison fails it.

Plain PyTorch and NumPy; imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from . import oracle

MAP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
LOWER = {"float32": torch.bfloat16, "bfloat16": torch.float8_e4m3fn,
         "float16": torch.float8_e4m3fn}


def _f32(x) -> np.float32:
    return np.float32(x)


class RefOcean:
    """The reference of `Ocean.update` at updates_per_second 0 for the
    cascades `specs` (with spectrum seeds) of `config`, on `device`."""

    def __init__(self, config: dict, specs: list, dt: float, device):
        if abs(config["g"] - float(oracle.G)) > 1e-6:
            raise ValueError("the oracle's g is 9.81")
        self.n = n = config["map_size"]
        self.depth = float(config["depth"])
        self.map_dtype = config["map_dtype"]
        self.device = torch.device(device)
        self.specs = specs
        self.dt32 = _f32(dt)
        self._h0, self._h0nc, self._omega, self._k = [], [], [], []
        for spec in specs:
            u = _f32(spec["wind_speed"])
            fetch_m = _f32(spec["fetch_length"]) * _f32(1e3)
            tile = tuple(_f32(v) for v in spec["tile_length"])
            angle = _f32(spec["wind_direction"]) * _f32(np.pi / 180)
            h0, h0nc = oracle.packed_spectrum(
                n, spec["spectrum_seed"], tile,
                alpha=oracle.jonswap_alpha(u, fetch_m),
                w_p=oracle.jonswap_peak_angular_frequency(u, fetch_m), wind_speed=u,
                angle=angle, depth=self.depth, swell=_f32(spec["swell"]),
                detail=_f32(spec["detail"]), spread=_f32(spec["spread"]))
            self._h0.append(h0)
            self._h0nc.append(h0nc)
            # the k-grid of the oracle's modulate (spectrum_modulate.glsl), fp32
            ids = np.arange(n, dtype=np.float32)
            kx = (ids[None, :] - _f32(n) * _f32(0.5)) * _f32(2.0 * oracle.PI) / tile[0]
            ky = (ids[:, None] - _f32(n) * _f32(0.5)) * _f32(2.0 * oracle.PI) / tile[1]
            kx, ky = np.broadcast_arrays(kx, ky)
            k = np.sqrt(kx * kx + ky * ky) + _f32(1e-6)
            self._omega.append(oracle.dispersion_relation(k, self.depth)[0])
            self._k.append((kx, ky, k))
        self.t0 = [_f32(_f32(120.0) + _f32(_f32(np.pi) * _f32(i))) for i in range(len(specs))]
        self._times = np.zeros((0, len(specs)), np.float32)
        self._on_device = {}
        sign = (np.add.outer(np.arange(n), np.arange(n)) % 2) * -2 + 1
        self._sign = torch.as_tensor(sign, dtype=torch.float64, device=self.device)

    @property
    def num_cascades(self) -> int:
        return len(self.specs)

    def time(self, update: int) -> np.ndarray:
        """Each cascade's fp32 time after `update` + 1 updates (the time the
        update of index `update` modulates at), accumulated one fp32 add an
        update as the program's state does."""
        if update >= len(self._times):
            steps = np.full((update + 1 + 4096, len(self.specs)), self.dt32, np.float32)
            steps[0] += np.asarray(self.t0, np.float32)
            self._times = np.cumsum(steps, axis=0, dtype=np.float32)
        return self._times[update]

    def scales(self) -> torch.Tensor:
        """(C, 4) fp32 (1/Lx, 1/Ly, displacement_scale, normal_scale)."""
        tile = torch.tensor([s["tile_length"] for s in self.specs], dtype=torch.float32)
        uv = 1.0 / tile
        rest = torch.tensor([[s["displacement_scale"], s["normal_scale"]] for s in self.specs],
                            dtype=torch.float32)
        return torch.cat([uv, rest], dim=1).to(self.device)

    def _foam_rates(self, c: int):
        amount = float(_f32(self.specs[c]["foam_amount"]))
        dt = float(self.dt32)
        return dt * amount * 7.5, dt * max(10.0 - amount, 0.5) * 1.15

    def _constants(self, c: int):
        """Cascade c's h0, conj(h0(-k)) (complex128), omega (fp32) and k-grid
        (float64) on the device, copied there once."""
        if c not in self._on_device:
            on = lambda a: torch.as_tensor(a, device=self.device)
            self._on_device[c] = (on(self._h0[c]).to(torch.complex128),
                                  on(self._h0nc[c]).to(torch.complex128), on(self._omega[c]),
                                  *(on(v).double() for v in self._k[c]))
        return self._on_device[c]

    def _layers(self, c: int, update: int) -> torch.Tensor:
        """(4, N, N) complex128 packed layers of cascade c at its time."""
        h0, h0nc, omega, kx, ky, k = self._constants(c)
        t32 = self.time(update)[c]
        phase = (omega * float(t32)).double()        # omega * t in fp32, one rounding
        mod = torch.polar(torch.ones_like(phase), phase)
        h = h0 * mod + h0nc * torch.conj(mod)
        kux, kuy = kx / k, ky / k
        ih = 1j * h
        hx, hy, hz = ih * kuy, h, ih * kux
        dhy_dx, dhy_dz = ih * ky, ih * kx
        dhx_dx, dhz_dz, dhz_dx = -h * ky * kuy, -h * kx * kux, -h * ky * kux
        return torch.stack([hx + 1j * hy, hz + 1j * dhy_dx, dhy_dz + 1j * dhx_dx,
                            dhz_dz + 1j * dhz_dx])

    def _unpack(self, c: int, fields: torch.Tensor, foam_in: torch.Tensor):
        s = self._sign if fields.dtype == torch.complex128 else self._sign.float()
        re, im = fields.real * s, fields.imag * s
        hx, hy, hz, dhy_dx = re[0], im[0], re[1], im[1]
        dhy_dz, dhx_dx, dhz_dz, dhz_dx = re[2], im[2], re[3], im[3]
        spec = self.specs[c]
        grow, decay = self._foam_rates(c)
        jac = (1.0 + dhx_dx) * (1.0 + dhz_dz) - dhz_dx * dhz_dx
        factor = -torch.clamp_max(jac - float(_f32(spec["whitecap"])), 0.0)
        foam = torch.clamp(foam_in.to(re.dtype) * np.exp(-decay) + factor * grow, 0.0, 1.0)
        disp = torch.stack([hx, hy, hz])
        normal = torch.stack([dhy_dx / (1.0 + dhx_dx.abs()), dhy_dz / (1.0 + dhz_dz.abs()),
                              dhx_dx, foam])
        return disp, normal, foam

    def step(self, c: int, foam_in: torch.Tensor, update: int):
        """Cascade c's update of index `update` from `foam_in` (N, N):
        (displacement (3, N, N), normal (4, N, N), foam (N, N)), float64."""
        n = self.n
        fields = (torch.fft.ifft2(self._layers(c, update)) * (n * n)).transpose(-2, -1)
        return self._unpack(c, fields, foam_in)

    def control_step(self, c: int, foam_in: torch.Tensor, update: int):
        """`step` one precision lower: the transform's input, intermediate and
        output rounded to bf16 (in place of an fp32 core), fp32 after it, and
        the maps rounded to the format below the stated map dtype."""
        n = self.n
        low = lambda z: torch.complex(z.real.to(torch.bfloat16).float(),
                                      z.imag.to(torch.bfloat16).float())
        layers = low(self._layers(c, update).to(torch.complex64))
        rows = low(torch.fft.ifft(layers, dim=-1) * n)
        fields = low(torch.fft.ifft(rows, dim=-2) * n).transpose(-2, -1)
        disp, normal, foam = self._unpack(c, fields, foam_in.float())
        lower = LOWER[self.map_dtype]
        return (disp.to(lower).to(torch.float64), normal.to(lower).to(torch.float64),
                foam.double())

    @property
    def map_torch_dtype(self) -> torch.dtype:
        return MAP_DTYPES[self.map_dtype]

    def as_map_dtype(self, x: torch.Tensor) -> torch.Tensor:
        """`x` rounded to the configuration's map dtype, as float64."""
        return x.to(self.map_torch_dtype).to(torch.float64)
