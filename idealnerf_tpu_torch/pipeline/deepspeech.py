"""DeepSpeech 0.1.0 acoustic model (counterpart of pipeline/deepspeech.py;
reference: data_util/deepspeech_features/deepspeech_features.py:16-275,
which runs the frozen TF graph ``output_graph.pb``).

Architecture (Mozilla DeepSpeech v0.1.0):
  input (T, 494 = 26 cepstra x (2*9+1) context)
  -> 3x [FC 2048 + ReLU clipped at 20]
  -> bidirectional LSTM (BasicLSTMCell 2048, forget_bias=1, TF gate
     order [i, j, f, o])
  -> FC 2048 (clipped ReLU, over concat fw‖bw)
  -> FC 29 logits (raw, no softmax — the reference consumes logits).

``DeepSpeech`` is an ``nn.Module`` whose parameters are the graph's
variables in their TF layout, under the JAX package's names (``h1``,
``b1``, ..., ``fw_kernel``, ``fw_bias``); the LSTM is a loop over T with
one (x‖h)·W product a step. The weight loader parses the frozen GraphDef
without TensorFlow: a minimal protobuf wire-format reader extracts Const
tensors by name, and ``save_frozen_graph`` writes the same subset of the
format (numpy and ``struct`` only, copied from the JAX module).
"""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

RELU_CLIP = 20.0
FORGET_BIAS = 1.0
N_LOGITS = 29

# ------------------------------------------------------------ mini-protobuf
# Wire format only; schema knowledge inlined for GraphDef/NodeDef/
# AttrValue/TensorProto (tensorflow/core/framework/*.proto).

_DT_FLOAT, _DT_INT32 = 1, 3


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wtype = key >> 3, key & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _parse_tensor(buf: bytes) -> Optional[np.ndarray]:
    """TensorProto -> ndarray (float32/int32, content or packed vals)."""
    dtype = _DT_FLOAT
    shape: List[int] = []
    content = b""
    float_vals: List[float] = []
    int_vals: List[int] = []
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:
            dtype = val
        elif fnum == 2:  # TensorShapeProto: field 2 = repeated Dim{1: size}
            for f2, _, v2 in _fields(val):
                if f2 == 2:
                    for f3, _, v3 in _fields(v2):
                        if f3 == 1:
                            shape.append(v3)
        elif fnum == 4:
            content = val
        elif fnum == 6:  # packed float_val
            if wtype == 2:
                float_vals.extend(
                    struct.unpack(f"<{len(val)//4}f", val))
            else:
                float_vals.append(struct.unpack("<f", val)[0])
        elif fnum == 8 and wtype == 0:
            int_vals.append(val)
    if dtype == _DT_FLOAT:
        np_dtype = np.float32
        vals = float_vals
    elif dtype == _DT_INT32:
        np_dtype = np.int32
        vals = int_vals
    else:
        return None
    if content:
        arr = np.frombuffer(content, np_dtype)
    elif vals:
        arr = np.asarray(vals, np_dtype)
        if shape and arr.size == 1:       # scalar fill
            arr = np.full(int(np.prod(shape)), arr[0], np_dtype)
    else:
        arr = np.zeros(int(np.prod(shape)) if shape else 0, np_dtype)
    return arr.reshape(shape) if shape else arr


def load_frozen_graph_consts(path: str) -> Dict[str, np.ndarray]:
    """Parse a frozen GraphDef .pb and return {node_name: const tensor}."""
    with open(path, "rb") as f:
        buf = f.read()
    consts: Dict[str, np.ndarray] = {}
    for fnum, _, node in _fields(buf):
        if fnum != 1:
            continue
        name = op = None
        tensor = None
        for f2, _, v2 in _fields(node):
            if f2 == 1:
                name = v2.decode()
            elif f2 == 2:
                op = v2.decode()
            elif f2 == 5:  # attr map entry {1: key, 2: AttrValue}
                key = None
                attr = None
                for f3, _, v3 in _fields(v2):
                    if f3 == 1:
                        key = v3.decode()
                    elif f3 == 2:
                        attr = v3
                if key == "value" and attr is not None:
                    for f4, _, v4 in _fields(attr):
                        if f4 == 8:
                            tensor = _parse_tensor(v4)
        if op == "Const" and name and tensor is not None:
            consts[name] = tensor
    return consts


def _write_varint(out: bytearray, v: int):
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_field(out: bytearray, fnum: int, wtype: int, payload: bytes):
    _write_varint(out, (fnum << 3) | wtype)
    if wtype == 2:
        _write_varint(out, len(payload))
    out.extend(payload)


def save_frozen_graph(path: str, consts: Dict[str, np.ndarray]):
    """Write {name: float32 array} as Const nodes of a minimal frozen
    GraphDef — the converter test's fixture writer."""
    graph = bytearray()
    for name, arr in consts.items():
        arr = np.asarray(arr, np.float32)
        shape = bytearray()
        for d in arr.shape:
            dim = bytearray()
            _write_varint(dim, (1 << 3) | 0)
            _write_varint(dim, d)
            _write_field(shape, 2, 2, bytes(dim))
        tensor = bytearray()
        _write_varint(tensor, (1 << 3) | 0)
        _write_varint(tensor, _DT_FLOAT)
        _write_field(tensor, 2, 2, bytes(shape))
        _write_field(tensor, 4, 2, arr.tobytes())
        attrv = bytearray()
        _write_field(attrv, 8, 2, bytes(tensor))
        entry = bytearray()
        _write_field(entry, 1, 2, b"value")
        _write_field(entry, 2, 2, bytes(attrv))
        node = bytearray()
        _write_field(node, 1, 2, name.encode())
        _write_field(node, 2, 2, b"Const")
        _write_field(node, 5, 2, bytes(entry))
        _write_field(graph, 1, 2, bytes(node))
    with open(path, "wb") as f:
        f.write(bytes(graph))


# frozen-graph const names (DeepSpeech v0.1.0 export); matched by suffix
# so an import prefix ("deepspeech/...") doesn't matter.
_VAR_SUFFIXES = {
    "h1": "h1", "b1": "b1", "h2": "h2", "b2": "b2", "h3": "h3", "b3": "b3",
    "h5": "h5", "b5": "b5", "h6": "h6", "b6": "b6",
    "bidirectional_rnn/fw/basic_lstm_cell/kernel": "fw_kernel",
    "bidirectional_rnn/fw/basic_lstm_cell/bias": "fw_bias",
    "bidirectional_rnn/bw/basic_lstm_cell/kernel": "bw_kernel",
    "bidirectional_rnn/bw/basic_lstm_cell/bias": "bw_bias",
}


def params_from_consts(consts: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """Map frozen-graph Const names to the model's float32 parameters."""
    params = {}
    for name, arr in consts.items():
        for suffix, key in _VAR_SUFFIXES.items():
            if name == suffix or name.endswith("/" + suffix):
                params[key] = np.asarray(arr, np.float32)
    missing = set(_VAR_SUFFIXES.values()) - set(params)
    if missing:
        raise ValueError(f"frozen graph missing variables: {sorted(missing)}")
    return params


def load_params(pb_path: str) -> Dict[str, np.ndarray]:
    return params_from_consts(load_frozen_graph_consts(pb_path))


def consts_from_params(params) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_consts``: the parameters (arrays or
    tensors) under the v0.1.0 graph's variable names, for
    ``save_frozen_graph``."""
    names = {key: suffix for suffix, key in _VAR_SUFFIXES.items()}
    return {names[k]: np.asarray(v.detach().cpu() if isinstance(
        v, torch.Tensor) else v, np.float32) for k, v in params.items()}


def random_params(generator: torch.Generator, n_input: int = 494,
                  n_hidden: int = 2048, scale: float = 0.05
                  ) -> Dict[str, torch.Tensor]:
    """Random weights with the exact v0.1.0 topology (a small n_hidden for
    tests; 2048 matches the release graph), N(0, scale²) from
    ``generator``, biases zero."""
    h = n_hidden

    def w(*shape):
        return torch.randn(shape, generator=generator) * scale

    return {
        "h1": w(n_input, h), "b1": torch.zeros(h),
        "h2": w(h, h), "b2": torch.zeros(h),
        "h3": w(h, h), "b3": torch.zeros(h),
        "fw_kernel": w(2 * h, 4 * h), "fw_bias": torch.zeros(4 * h),
        "bw_kernel": w(2 * h, 4 * h), "bw_bias": torch.zeros(4 * h),
        "h5": w(2 * h, h), "b5": torch.zeros(h),
        "h6": w(h, N_LOGITS), "b6": torch.zeros(N_LOGITS),
    }


def _clipped_relu(x):
    return torch.clamp(x, 0.0, RELU_CLIP)


class DeepSpeech(nn.Module):
    """``forward(x (T, n_input))`` -> (T, 29) logits."""

    def __init__(self, n_input: int = 494, n_hidden: int = 2048,
                 device=None):
        super().__init__()
        h = n_hidden
        shapes = {"h1": (n_input, h), "b1": (h,), "h2": (h, h), "b2": (h,),
                  "h3": (h, h), "b3": (h,), "fw_kernel": (2 * h, 4 * h),
                  "fw_bias": (4 * h,), "bw_kernel": (2 * h, 4 * h),
                  "bw_bias": (4 * h,), "h5": (2 * h, h), "b5": (h,),
                  "h6": (h, N_LOGITS), "b6": (N_LOGITS,)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, device=device), requires_grad=False))

    @classmethod
    def from_params(cls, params, device=None) -> "DeepSpeech":
        """A net holding ``params`` (numpy arrays or tensors under the
        names above), its sizes read from them."""
        sd = {k: v.float() if isinstance(v, torch.Tensor)
              else torch.from_numpy(np.array(v, np.float32))
              for k, v in params.items()}
        net = cls(sd["h1"].shape[0], sd["h1"].shape[1], device=device)
        net.load_state_dict(sd)
        return net

    def _lstm(self, kernel, bias, xs):
        """BasicLSTMCell over time: xs (T, H) -> hs (T, H). TF gate layout
        [i, j, f, o]; c' = c·sigmoid(f + forget_bias) + sigmoid(i)·tanh(j);
        h' = tanh(c')·sigmoid(o)."""
        h_dim = kernel.shape[1] // 4
        c = xs.new_zeros(h_dim)
        h = xs.new_zeros(h_dim)
        hs = []
        for x in xs:
            gates = torch.cat([x, h]) @ kernel + bias
            i, j, f, o = torch.split(gates, h_dim)
            c = c * torch.sigmoid(f + FORGET_BIAS) + torch.sigmoid(i) * torch.tanh(j)
            h = torch.tanh(c) * torch.sigmoid(o)
            hs.append(h)
        return torch.stack(hs)

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _clipped_relu(x @ self.h1 + self.b1)
        h = _clipped_relu(h @ self.h2 + self.b2)
        h = _clipped_relu(h @ self.h3 + self.b3)
        fw = self._lstm(self.fw_kernel, self.fw_bias, h)
        bw = self._lstm(self.bw_kernel, self.bw_bias, h.flip(0)).flip(0)
        h = _clipped_relu(torch.cat([fw, bw], -1) @ self.h5 + self.b5)
        return h @ self.h6 + self.b6


def deepspeech_logits(net: DeepSpeech, x) -> torch.Tensor:
    """(T, n_input) standardized MFCC context windows -> (T, 29) logits
    on the net's device."""
    return net(torch.as_tensor(np.asarray(x, np.float32),
                               device=net.h1.device))


def make_logits_fn(net: DeepSpeech) -> Callable:
    """Adapter for audio.extract_deepspeech_features(logits_fn=...): numpy
    in and out, the net run on its device."""
    def fn(input_vector: np.ndarray) -> np.ndarray:
        return deepspeech_logits(net, input_vector).cpu().numpy()
    return fn


def make_logits_fn_from_graph(pb_path: str, device="cuda") -> Callable:
    """Drop-in for the reference's TF-session net_fn
    (deepspeech_features.py:59-63), minus TensorFlow."""
    return make_logits_fn(DeepSpeech.from_params(load_params(pb_path),
                                                 device=device))
