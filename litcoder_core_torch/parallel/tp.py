"""Tensor-parallel feature extraction over a 2-D ('data', 'model') mesh
(twin of litcoder_core_tpu/parallel/tp.py).

Megatron-style tensor parallelism on torch modules, driven by one process:
- `make_lm_mesh` builds the ('data', 'model') grid of torch devices;
- `spec_for_param` maps a parameter's torch name and shape to the axes it
  splits on: column-parallel projections (attention q/k/v or GPT-2's fused
  c_attn, MLP up/gate) split their OUTPUT dim and their bias with it,
  row-parallel projections (attention out, MLP down) their INPUT dim,
  everything else (embeddings, norms, unknown names) replicates;
- `shard_lm_params` gives each 'data' group its own copy of the model with
  every matched projection swapped for a module that holds one shard per
  'model'-axis device. A column-parallel module computes each output slice
  on its shard's device and concatenates them; a row-parallel one splits
  the input's last dim, sums the partial products on the group's first
  device (the all-reduce) and adds the bias once, after the sum;
- `pad_and_shard` splits batch rows over the 'data' groups, padding with
  zero rows.

A dim the 'model' extent does not divide stays replicated, as in JAX. The
row-parallel sum reorders the fp32 reduction, so a TP forward matches the
unsharded one to rounding, not bit for bit.
"""

import copy
import logging
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from litcoder_core_torch.parallel.mesh import Mesh

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
MODEL_AXIS = "model"

# Column-parallel: shard the matmul OUTPUT dim (and the bias with it).
# GPT-2's fused qkv and MLP-up (c_attn/c_fc), separate-projection families
# (q/k/v_proj, llama up/gate) and BERT/T5/Wav2Vec2-style names, with the
# '.' separators of torch module paths.
_COL_PARALLEL = re.compile(
    r"(c_attn|c_fc|q_proj|k_proj|v_proj|query|key|value|gate_proj|up_proj"
    r"|wi_0|wi_1|wi|fc1|intermediate\.dense|intermediate_dense)(\.|$)"
)
# Row-parallel: shard the matmul INPUT dim; the bias replicates (it is
# added after the cross-shard sum).
_ROW_PARALLEL = re.compile(
    r"(c_proj|o_proj|out_proj|down_proj|wo|fc2|attn\.dense|attention\.dense"
    r"|output\.dense|output_dense)(\.|$)"
)
# HF torch GPT-2 builds these from transformers' Conv1D, whose weight is
# (in_features, out_features); nn.Linear's is (out_features, in_features).
_CONV1D_LAYOUT = re.compile(r"(c_attn|c_fc|c_proj)(\.|$)")

REPLICATED: Tuple = ()


def make_lm_mesh(n_data: int = 1, n_model: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 device="cuda") -> Mesh:
    """2-D ('data', 'model') mesh over the first n_data * n_model devices:
    the given `devices` (which may repeat one), else the CUDA cards, or for
    a CPU `device` n_data * n_model entries of the CPU.

    Like `mesh.make_mesh`, it never truncates silently: asking for more
    devices than exist raises with the count it needed."""
    if devices is None:
        if torch.device(device).type == "cpu":
            devices = ["cpu"] * (n_data * (n_model or 1))
        else:
            count = (torch.cuda.device_count() if torch.cuda.is_available()
                     else 0)
            devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if n_model is None:
        n_model = len(devices) // n_data
    need = n_data * n_model
    if n_model < 1 or len(devices) < need:
        # n_model < 1 happens when n_data alone exceeds the device count:
        # without this check `need` would be 0 and an empty mesh would
        # slip through.
        platform = (torch.device(devices[0]).type if devices
                    else torch.device(device).type)
        raise RuntimeError(
            f"make_lm_mesh({n_data}, {n_model}) needs "
            f"{max(need, n_data)} devices but only {len(devices)} exist "
            f"(platform={platform})"
        )
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def spec_for_param(path: str, shape: Tuple[int, ...], n_model: int,
                   conv1d: Optional[bool] = None) -> Tuple:
    """The axes one parameter splits on: a tuple with MODEL_AXIS at the
    sharded dim and None elsewhere, or REPLICATED (()).

    nn.Linear weights are (out, in); transformers' Conv1D weights (GPT-2's
    c_attn/c_fc/c_proj, or `conv1d=True`) are (in, out). Column-parallel
    shards the OUT dim, row-parallel the IN dim, resolved against that
    layout and only when n_model divides it. 1-D parameters shard only as
    the bias of a column-parallel projection."""
    ndim = len(shape)
    col = _COL_PARALLEL.search(path) is not None
    row = _ROW_PARALLEL.search(path) is not None
    if conv1d is None:
        conv1d = _CONV1D_LAYOUT.search(path) is not None
    if ndim == 2 and (col or row):
        out_dim = 1 if conv1d else 0
        dim = out_dim if col else 1 - out_dim
        if shape[dim] % n_model == 0:
            spec = [None, None]
            spec[dim] = MODEL_AXIS
            return tuple(spec)
    if ndim == 1 and col and "bias" in path and shape[0] % n_model == 0:
        return (MODEL_AXIS,)
    return REPLICATED


def check_tp_mesh(mesh, device: torch.device) -> Optional[Mesh]:
    """An extractor's `mesh` argument: None, or a ('data', 'model') Mesh
    whose devices are of the extractor's device type."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(
            "mesh must be a litcoder_core_torch.parallel.mesh.Mesh (build "
            f"one with make_lm_mesh); got {type(mesh).__name__}")
    if mesh.axis_names != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(
            f"extraction mesh needs axes ('{DATA_AXIS}', '{MODEL_AXIS}'); "
            f"got {mesh.axis_names}")
    kinds = {d.type for d in mesh.devices.flat}
    if kinds != {device.type}:
        raise ValueError(
            f"the extractor runs on {str(device)!r} but the mesh's devices "
            f"are {sorted(kinds)}")
    return mesh


def _is_conv1d(module: nn.Module) -> bool:
    return type(module).__name__ == "Conv1D" and hasattr(module, "nf")


class _ParallelProjection(nn.Module):
    """A projection split over one 'data' group's 'model' devices.

    Column-parallel: shard j holds output slice j (weight and bias), so
    each device computes its slice and the slices concatenate on the
    input's device. Row-parallel: shard j holds input slice j; the partial
    products sum on the input's device, then the replicated bias is
    added."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 devices: Sequence[torch.device], column: bool,
                 conv1d: bool):
        super().__init__()
        self.column = column
        self.conv1d = conv1d
        n = len(devices)
        out_dim = 1 if conv1d else 0
        dim = out_dim if column else 1 - out_dim
        self.weights = nn.ParameterList([
            nn.Parameter(w.to(d).contiguous(), requires_grad=False)
            for w, d in zip(torch.chunk(weight.detach(), n, dim=dim),
                            devices)])
        if bias is None:
            self.biases = None
        elif column:
            self.biases = nn.ParameterList([
                nn.Parameter(b.to(d).contiguous(), requires_grad=False)
                for b, d in zip(torch.chunk(bias.detach(), n), devices)])
        else:
            self.biases = nn.ParameterList([
                nn.Parameter(bias.detach().to(devices[0]),
                             requires_grad=False)])
        self.in_sizes = [w.shape[0 if conv1d else 1] for w in self.weights]

    def _matmul(self, x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor]) -> torch.Tensor:
        if self.conv1d:
            y = x @ w
            return y if b is None else y + b
        return nn.functional.linear(x, w, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        home = x.device
        if self.column:
            outs = []
            for j, w in enumerate(self.weights):
                b = None if self.biases is None else self.biases[j]
                outs.append(self._matmul(x.to(w.device), w, b).to(home))
            return torch.cat(outs, dim=-1)
        total = None
        for xj, w in zip(torch.split(x, self.in_sizes, dim=-1),
                         self.weights):
            part = self._matmul(xj.to(w.device), w, None).to(home)
            total = part if total is None else total + part
        if self.biases is not None:
            total = total + self.biases[0].to(home)
        return total


def shard_lm_params(model: nn.Module, mesh: Mesh) -> List[nn.Module]:
    """One tensor-parallel copy of `model` per 'data' group of `mesh`.

    Copy g lives on mesh.devices[g, 0], except its matched projections,
    which become column- or row-parallel modules holding one shard on each
    of mesh.devices[g, :]. The caller's model is not changed. Logs a
    one-line count of the tensors sharded and replicated."""
    n_model = mesh.shape[MODEL_AXIS]
    counts = {"sharded": 0, "replicated": 0}
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name \
            else model
        spec = spec_for_param(name, tuple(p.shape), n_model,
                              conv1d=_is_conv1d(owner))
        counts["sharded" if spec != REPLICATED else "replicated"] += 1

    copies = []
    for g in range(mesh.devices.shape[0]):
        devices = list(mesh.devices[g])
        tp = copy.deepcopy(model).to(devices[0]).eval()
        for path, module in list(tp.named_modules()):
            if not (isinstance(module, nn.Linear) or _is_conv1d(module)):
                continue
            conv1d = _is_conv1d(module)
            spec = spec_for_param(path + ".weight",
                                  tuple(module.weight.shape), n_model,
                                  conv1d=conv1d)
            if spec == REPLICATED:
                continue
            column = _COL_PARALLEL.search(path + ".weight") is not None
            parent_path, _, attr = path.rpartition(".")
            parent = tp.get_submodule(parent_path) if parent_path else tp
            setattr(parent, attr, _ParallelProjection(
                module.weight, module.bias, devices, column, conv1d))
        copies.append(tp)
    logger.info(
        "TP placement over %s mesh %s: %d tensors sharded, %d replicated",
        mesh.shape, mesh.devices.shape, counts["sharded"],
        counts["replicated"],
    )
    return copies


def shard_batch(arrays, mesh: Mesh):
    """Split a tuple of (B, ...) arrays on their rows over the 'data'
    groups: for each array, a list of per-group row blocks on each group's
    first device. B must be a multiple of the 'data' extent (use
    `pad_and_shard`)."""
    n_data = mesh.shape[DATA_AXIS]
    homes = [mesh.devices[g, 0] for g in range(n_data)]
    out = []
    for a in arrays:
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
            np.asarray(a))
        if t.shape[0] % n_data:
            raise ValueError(
                f"batch of {t.shape[0]} rows does not divide the 'data' "
                f"axis ({n_data}); pad it with pad_and_shard")
        out.append([blk.to(d) for blk, d in zip(torch.chunk(t, n_data),
                                                homes)])
    return tuple(out)


def pad_batch_rows(n_rows: int, mesh: Mesh) -> int:
    """Rows of padding needed so a batch divides the 'data' axis."""
    return (-n_rows) % mesh.shape[DATA_AXIS]


def pad_and_shard(arrays, mesh: Mesh):
    """Pad a tuple of (B, ...) arrays with zero rows to a multiple of the
    'data' extent and shard them. Returns (sharded arrays, n_pad); callers
    drop the padding rows from the output before pooling (a zero row has
    an all-zero attention mask or a silent audio window)."""
    n_pad = pad_batch_rows(arrays[0].shape[0], mesh)
    if n_pad:
        padded = []
        for a in arrays:
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a))
            padded.append(torch.cat([t, t.new_zeros((n_pad,) + t.shape[1:])]))
        arrays = tuple(padded)
    return shard_batch(arrays, mesh), n_pad


def tp_forward(models: Sequence[nn.Module], mesh: Mesh, home: torch.device,
               inputs, **kwargs):
    """hidden_states of a TP forward: `inputs` (a dict of (B, ...) batch
    tensors) pad and split over the 'data' groups, each group's model runs
    its rows, and every layer's states return to `home` with the pad rows
    dropped."""
    names = list(inputs)
    shards, n_pad = pad_and_shard(tuple(inputs[k] for k in names), mesh)
    n_rows = inputs[names[0]].shape[0]
    per_group = []
    for g, model in enumerate(models):
        out = model(**{k: s[g] for k, s in zip(names, shards)}, **kwargs)
        per_group.append(out.hidden_states)
    return tuple(torch.cat([h[i].to(home) for h in per_group])[:n_rows]
                 for i in range(len(per_group[0])))
