"""Fused batched TM + LDDT survivor gating with device-side coordinate
gather, in plain PyTorch.

Counterpart of `foldseek_tpu/ops/gates_device.py` (an XLA program there, not
a Pallas kernel). The stage is built around the device:

* the target DB's flat C-alpha array ([R, 3] float32) is uploaded once and
  stays resident with the DB's other device data (`db/panels.py`
  `TorchPanelSet.ca`); per fleet only int32 gather indices and the small
  query coordinates go up;
* per bucket of alignment lengths, one program gathers the aligned
  coordinates from the resident arrays and computes TM
  (`ops/tm_device.py`) and LDDT (`ops/lddt.py` `lddt_chunk`) in chunks that
  bound the temporaries;
* `GateFleet.dispatch` enqueues the program and its copy home through a
  pinned buffer; it waits for the device only where the TM search asks
  whether it converged (`check_every`), and `GateFleet.result` waits for the
  one [3, P] readback.

Reference: structurealign.cpp:377-407 computes TM + LDDT per accepted hit
inside the omp-for; the batched fleet is its device re-expression.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import add_count
from .lddt import lddt_chunk, lddt_chunk_for
from .tm_device import (_params_for, default_check_every, tm_chunk,
                        tm_chunk_for)

# alignment-length buckets of the fleets: multiples of this many columns
M_PAD_STEP = 64


def m_pad_for(m: int) -> int:
    """Padded column count of the bucket an alignment of m columns joins."""
    return max(M_PAD_STEP, -(-m // M_PAD_STEP) * M_PAD_STEP)


def run_gates(t_panel: torch.Tensor, q_coords: torch.Tensor,
              q_deg: torch.Tensor, qabs: torch.Tensor, tabs: torch.Tensor,
              m_len: torch.Tensor, scal: torch.Tensor, norm: torch.Tensor,
              need_tm: bool, need_lddt: bool,
              check_every: int) -> torch.Tensor:
    """The fused program of one bucket. t_panel [R, 3], q_coords [Rq, 3],
    q_deg [Rq] float32; qabs, tabs int32 [P, M] absolute rows of each
    aligned column; m_len, norm int32 [P]; scal float32 [4, P]. Returns
    float32 [3, P]: TM, LDDT, scored LDDT columns. Nothing here waits for
    the device unless check_every > 0."""
    P, M = qabs.shape
    dev = qabs.device
    tm = torch.zeros(P, dtype=torch.float32, device=dev)
    lddt = torch.zeros(P, dtype=torch.float32, device=dev)
    n_ok = torch.zeros(P, dtype=torch.float32, device=dev)
    if need_tm:
        chunk = tm_chunk_for(M)
        for c in range(0, P, chunk):
            s = slice(c, c + chunk)
            # x = target superposed onto y = query (TMaligner convention)
            tm[s] = tm_chunk(t_panel[tabs[s]], q_coords[qabs[s]], m_len[s],
                             scal[:, s], check_every)
        tm = tm * m_len.to(torch.float32) / norm.to(torch.float32).clamp_min(1.0)
    if need_lddt:
        chunk = lddt_chunk_for(M)
        for c in range(0, P, chunk):
            s = slice(c, c + chunk)
            lddt[s], n_ok[s] = lddt_chunk(q_coords[qabs[s]], t_panel[tabs[s]],
                                          q_deg[qabs[s]], m_len[s])
    return torch.stack([tm, lddt, n_ok])


class GateFleet:
    """One bucket's worth of survivor gating work.

    Fill the int32 absolute gather indices on the host; `dispatch` uploads
    them and enqueues the fused program (with check_every = 0 without
    waiting for any of it); `result()` waits for the single [3, P]
    readback."""

    def __init__(self, m_pad: int, n_items: int, need_tm: bool,
                 need_lddt: bool):
        self.m_pad = m_pad
        self.need_tm = need_tm
        self.need_lddt = need_lddt
        self.n = n_items
        self.qabs = np.zeros((n_items, m_pad), np.int32)
        self.tabs = np.zeros((n_items, m_pad), np.int32)
        self.m_len = np.zeros(n_items, np.int32)
        self.norm = np.ones(n_items, np.int32)
        self._out = None
        self._event = None

    def dispatch(self, t_panel: torch.Tensor, q_coords: torch.Tensor,
                 q_deg: torch.Tensor, check_every: int = -1) -> None:
        dev = t_panel.device
        if check_every < 0:
            check_every = default_check_every(dev)
        scal = (np.stack(_params_for(self.norm)) if self.need_tm
                else np.zeros((4, self.n), np.float32))
        qabs, tabs, m_len, scal, norm = (
            torch.from_numpy(a).to(dev, non_blocking=True)
            for a in (self.qabs, self.tabs, self.m_len, scal, self.norm))
        out = run_gates(t_panel, q_coords, q_deg, qabs, tabs, m_len, scal,
                        norm, self.need_tm, self.need_lddt, check_every)
        if dev.type == "cuda":
            # the copy home is enqueued behind the program; the event marks
            # its end, and only result() waits for it
            self._out = torch.empty(out.shape, dtype=out.dtype,
                                    pin_memory=True)
            self._out.copy_(out, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(dev))
        else:
            self._out = out
        add_count("gate_fleets")

    def result(self) -> tuple:
        if self._event is not None:
            self._event.synchronize()
        out = self._out.numpy()
        return out[0], out[1], out[2]

