"""Read and write ``.safetensors`` files with no package beyond torch.

The format: an 8-byte little-endian header length n, n bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` plus an
optional ``"__metadata__"`` of strings), then the raw little-endian bytes
of every tensor, offsets counted from the end of the header.

``load_file`` maps the file (a private, copy-on-write ``mmap``) and returns
tensors that view it through ``torch.frombuffer``, so a tensor's pages are
read when it is first touched. Unlike ``safetensors.numpy``, which the JAX
package reads with, it reads bf16, the dtype of the released Wan shards.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
NAMES = {v: k for k, v in DTYPES.items()}


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, by name, on the CPU."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = (end - begin) // itemsize
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (base + begin) % itemsize:
            # an element that straddles its alignment: copy it out
            out[name] = torch.frombuffer(bytearray(buf[base + begin:
                                                       base + end]),
                                         dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                         offset=base + begin).reshape(shape)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (any device, contiguous or not) to ``path``, in
    name order; the header is padded with spaces to 8 bytes."""
    header: Dict[str, dict] = {}
    flat, offset = [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8)
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + raw.numel()]}
        flat.append(raw)
        offset += raw.numel()
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in flat:
            f.write(memoryview(raw.numpy()))
