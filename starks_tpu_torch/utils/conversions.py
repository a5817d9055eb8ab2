"""Host-side conversions between Python ints, port tensors and bytes.

Port convention: a 256-bit field element is 8 little-endian 32-bit words
of its canonical value, held in a `torch.int32` tensor of shape [..., 8]
(the words' bits reinterpreted as signed). That is 32 contiguous bytes
per element. Transcript serialization is 32-byte BIG-endian per
SURVEY.md §A.4; blake2s digests are 8 little-endian uint32 words.
"""

import numpy as np
import torch

NUM_WORDS = 8


def ints_to_tensor(xs, device=None) -> torch.Tensor:
    """List of ints in [0, 2^256) -> [N, 8] int32 tensor."""
    buf = b''.join(x.to_bytes(32, 'little') for x in xs)
    arr = np.frombuffer(buf, dtype='<i4').reshape(len(xs), NUM_WORDS)
    return torch.from_numpy(arr.copy()).to(device)


def int_to_tensor(x: int, device=None) -> torch.Tensor:
    """Single int in [0, 2^256) -> [8] int32 tensor."""
    return ints_to_tensor([x], device)[0]


def tensor_to_ints(t: torch.Tensor) -> list:
    raw = t.detach().cpu().contiguous().numpy().astype('<i4').tobytes()
    return [int.from_bytes(raw[i:i + 32], 'little')
            for i in range(0, len(raw), 32)]


def digest_words_to_bytes(words) -> bytes:
    """blake2s digest words (uint32 values, little-endian) -> bytes."""
    return np.asarray(words, dtype=np.uint32).astype('<u4').tobytes()
