"""Hand-rolled proto3 wire codec for the Triton gRPC inference contract.

The reference serves through NVIDIA Triton, whose gRPC endpoint speaks the
`inference.GRPCInferenceService` protobuf API; its benchmark client drives it
with named tensors (reference `runtime/triton_trtllm/client_grpc.py:227-307`:
inputs reference_wav FP32 [1,n], reference_wav_len INT32 [1,1],
reference_text / target_text BYTES [1,1]; output "waveform" FP32).

grpcio-tools (protoc codegen) is not available in this image, so this module
implements the proto3 WIRE FORMAT for the message subset directly — varints,
length-delimited fields, nested messages — matching `grpc_service.proto` from
the KServe/Triton predict-v2 protocol:

  ModelInferRequest:
    1 model_name(string)  2 model_version(string)  3 id(string)
    5 inputs(repeated InferInputTensor)  6 outputs(repeated ...)
    7 raw_input_contents(repeated bytes)
  InferInputTensor: 1 name  2 datatype  3 shape(repeated int64)  5 contents
  InferTensorContents: 1 bool 2 int 3 int64 4 uint 5 uint64 6 fp32(repeated
    float, packed)  7 fp64  8 bytes(repeated bytes)
  ModelInferResponse:
    1 model_name  2 model_version  3 id  5 outputs(InferOutputTensor)
    6 raw_output_contents(repeated bytes)

BYTES tensors in raw contents use Triton's 4-byte little-endian length prefix
per element. Field numbers are part of the public protocol; the codec itself
is original.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# --- proto3 primitives ------------------------------------------------------

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


def _enc_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7
        if shift >= 70:
            raise ValueError("varint overflow")


def _tag(fnum: int, wtype: int) -> bytes:
    return _enc_varint((fnum << 3) | wtype)


def enc_str(fnum: int, s: str | bytes) -> bytes:
    b = s.encode() if isinstance(s, str) else s
    return _tag(fnum, _LEN) + _enc_varint(len(b)) + b if b else b""


def enc_bytes_always(fnum: int, b: bytes) -> bytes:
    """Length-delimited field emitted even when empty (repeated elements)."""
    return _tag(fnum, _LEN) + _enc_varint(len(b)) + b


def enc_msg(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, _LEN) + _enc_varint(len(payload)) + payload


def enc_packed_varints(fnum: int, vals) -> bytes:
    if not len(vals):
        return b""
    body = b"".join(_enc_varint(int(v)) for v in vals)
    return _tag(fnum, _LEN) + _enc_varint(len(body)) + body


def iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a serialized message.
    value: int for varint/fixed, bytes for length-delimited."""
    i, n = 0, len(buf)
    while i < n:
        key, i = _dec_varint(buf, i)
        fnum, wtype = key >> 3, key & 7
        if wtype == _VARINT:
            v, i = _dec_varint(buf, i)
        elif wtype == _I64:
            v = struct.unpack_from("<q", buf, i)[0]
            i += 8
        elif wtype == _LEN:
            ln, i = _dec_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wtype == _I32:
            v = struct.unpack_from("<i", buf, i)[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, v


def _dec_packed_varints(v, wtype) -> list[int]:
    if wtype == _VARINT:
        return [v]
    out, i = [], 0
    while i < len(v):
        x, i = _dec_varint(v, i)
        out.append(x)
    return out


# --- Triton predict-v2 messages ---------------------------------------------

_NP_TO_TRITON = {np.dtype(np.float32): "FP32", np.dtype(np.float64): "FP64",
                 np.dtype(np.int32): "INT32", np.dtype(np.int64): "INT64",
                 np.dtype(np.bool_): "BOOL", np.dtype(np.uint8): "UINT8",
                 np.dtype(np.int16): "INT16"}
_TRITON_TO_NP = {"FP32": np.float32, "FP64": np.float64, "INT32": np.int32,
                 "INT64": np.int64, "BOOL": np.bool_, "UINT8": np.uint8,
                 "INT16": np.int16}


def np_to_triton_dtype(dt) -> str:
    dt = np.dtype(dt)
    if dt == object or dt.kind in ("S", "U"):
        return "BYTES"
    return _NP_TO_TRITON[dt]


def _bytes_tensor_raw(values) -> bytes:
    """Triton raw encoding of a BYTES tensor: 4-byte LE length prefix per
    element (tritonclient serialize_byte_tensor)."""
    out = bytearray()
    for v in np.asarray(values, dtype=object).reshape(-1):
        b = v.encode() if isinstance(v, str) else bytes(v)
        out += struct.pack("<I", len(b)) + b
    return bytes(out)


def _bytes_tensor_parse(raw: bytes) -> list[bytes]:
    out, i = [], 0
    while i < len(raw):
        (ln,) = struct.unpack_from("<I", raw, i)
        i += 4
        out.append(raw[i:i + ln])
        i += ln
    return out


@dataclass
class InferTensor:
    name: str
    datatype: str
    shape: tuple
    data: np.ndarray | list  # ndarray, or list[bytes] for BYTES

    def raw(self) -> bytes:
        if self.datatype == "BYTES":
            return _bytes_tensor_raw(self.data)
        return np.ascontiguousarray(
            np.asarray(self.data, _TRITON_TO_NP[self.datatype])).tobytes()

    def header(self, fnum_contents_allowed: bool = False) -> bytes:
        out = enc_str(1, self.name) + enc_str(2, self.datatype)
        out += enc_packed_varints(3, self.shape)
        return out


def encode_model_infer_request(model_name: str, inputs: list[InferTensor],
                               outputs: list[str] = (), request_id: str = "",
                               model_version: str = "") -> bytes:
    """Tensor data rides raw_input_contents (field 7), one blob per input in
    order — exactly how tritonclient ships it."""
    out = enc_str(1, model_name) + enc_str(2, model_version) + enc_str(3, request_id)
    for t in inputs:
        out += enc_msg(5, t.header())
    for name in outputs:
        out += enc_msg(6, enc_str(1, name))
    for t in inputs:
        out += enc_bytes_always(7, t.raw())
    return out


def _decode_tensor_header(buf: bytes) -> dict:
    t = {"name": "", "datatype": "", "shape": [], "contents": None}
    for fnum, wtype, v in iter_fields(buf):
        if fnum == 1:
            t["name"] = v.decode()
        elif fnum == 2:
            t["datatype"] = v.decode()
        elif fnum == 3:
            t["shape"] += _dec_packed_varints(v, wtype)
        elif fnum == 5:
            t["contents"] = bytes(v)
    return t


def _decode_contents(contents: bytes, datatype: str):
    """InferTensorContents: typed repeated fields (fallback when a client
    doesn't use raw contents)."""
    fp32, i64, byts = [], [], []
    for fnum, wtype, v in iter_fields(contents):
        if fnum == 6:  # fp32, packed
            fp32 += list(np.frombuffer(v, np.float32)) if wtype == _LEN else \
                [struct.unpack("<f", struct.pack("<i", v))[0]]
        elif fnum in (2, 3):
            i64 += _dec_packed_varints(v, wtype)
        elif fnum == 8:
            byts.append(bytes(v))
    if datatype == "BYTES":
        return byts
    if datatype in ("INT32", "INT64"):
        return np.asarray(i64, _TRITON_TO_NP[datatype])
    return np.asarray(fp32, np.float32)


def decode_model_infer_request(buf: bytes) -> dict:
    """-> {model_name, id, inputs: {name: ndarray|list[bytes]},
          outputs: [names]}"""
    headers, raws, outputs = [], [], []
    req = {"model_name": "", "id": ""}
    for fnum, wtype, v in iter_fields(buf):
        if fnum == 1:
            req["model_name"] = v.decode()
        elif fnum == 3:
            req["id"] = v.decode()
        elif fnum == 5:
            headers.append(_decode_tensor_header(v))
        elif fnum == 6:
            name = next((vv.decode() for fn, _, vv in iter_fields(v) if fn == 1), "")
            outputs.append(name)
        elif fnum == 7:
            raws.append(bytes(v))
    tensors = {}
    for idx, h in enumerate(headers):
        shape = tuple(h["shape"])
        if idx < len(raws):
            raw = raws[idx]
            if h["datatype"] == "BYTES":
                tensors[h["name"]] = _bytes_tensor_parse(raw)
            else:
                arr = np.frombuffer(raw, _TRITON_TO_NP[h["datatype"]])
                tensors[h["name"]] = arr.reshape(shape) if shape else arr
        elif h["contents"] is not None:
            data = _decode_contents(h["contents"], h["datatype"])
            if h["datatype"] != "BYTES" and shape:
                data = np.asarray(data).reshape(shape)
            tensors[h["name"]] = data
    req["inputs"] = tensors
    req["outputs"] = outputs
    return req


def encode_model_infer_response(model_name: str, outputs: list[InferTensor],
                                request_id: str = "",
                                model_version: str = "1") -> bytes:
    out = enc_str(1, model_name) + enc_str(2, model_version) + enc_str(3, request_id)
    for t in outputs:
        out += enc_msg(5, t.header())
    for t in outputs:
        out += enc_bytes_always(6, t.raw())
    return out


def decode_model_infer_response(buf: bytes) -> dict:
    headers, raws = [], []
    resp = {"model_name": "", "id": ""}
    for fnum, wtype, v in iter_fields(buf):
        if fnum == 1:
            resp["model_name"] = v.decode()
        elif fnum == 3:
            resp["id"] = v.decode()
        elif fnum == 5:
            headers.append(_decode_tensor_header(v))
        elif fnum == 6:
            raws.append(bytes(v))
    outputs = {}
    for idx, h in enumerate(headers):
        shape = tuple(h["shape"])
        if idx < len(raws):
            if h["datatype"] == "BYTES":
                outputs[h["name"]] = _bytes_tensor_parse(raws[idx])
            else:
                arr = np.frombuffer(raws[idx], _TRITON_TO_NP[h["datatype"]])
                outputs[h["name"]] = arr.reshape(shape) if shape else arr
        elif h["contents"] is not None:
            outputs[h["name"]] = _decode_contents(h["contents"], h["datatype"])
    resp["outputs"] = outputs
    return resp


# ServerReady / ServerLive: empty requests, bool field 1 responses
def encode_ready_response(ready: bool) -> bytes:
    return _tag(1, _VARINT) + _enc_varint(1 if ready else 0)


def decode_ready_response(buf: bytes) -> bool:
    for fnum, wtype, v in iter_fields(buf):
        if fnum == 1:
            return bool(v)
    return False
