"""libde265_tpu: an accelerator-resident HEVC decode engine in JAX.

Brand-new implementation with the capabilities of libde265
(github.com/ChristianFeldmann/libde265): serial bitstream/CABAC front-end
producing batched decode plans, JAX/XLA back-end for pixel
reconstruction, sharded across device meshes for tiles/frames.
"""
from .decoder import Decoder
from .api import (new_decoder, push_data, push_nal, flush_data, decode,
                  get_next_picture, decode_stream, decode_stream_native,
                  DecodedPicture)

__version__ = "0.1.0"
