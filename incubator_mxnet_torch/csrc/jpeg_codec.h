// The port's baseline JPEG codec (host C++), shared by the ctypes entry
// points of jpeg_codec.cc and the record pipeline of image_pipeline.cc.
#pragma once

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace mxhost {

// Decodes a baseline or extended-sequential Huffman JPEG at 1/scale_denom
// of its size (1, 2, 4 or 8, libjpeg's scaled IDCTs) into HWC uint8 with
// `out_channels` (3: RGB, 1: PIL's L weights of RGB; 0: the stream's own,
// 1 for gray and 3 for color).  Returns "" or the error; a progressive,
// arithmetic-coded, lossless, 12-bit or CMYK stream names its feature.
std::string JpegDecode(const uint8_t* data, size_t size, int scale_denom,
                       int out_channels, std::vector<uint8_t>* pixels,
                       int* height, int* width, int* channels);

// Encodes HWC uint8 (1 or 3 channels; color as 4:2:0) as a baseline JFIF
// JPEG with IJG's quality scaling of the Annex K tables and the Annex K
// Huffman tables, as PIL writes it at `quality`.
std::string JpegEncode(const uint8_t* pixels, int height, int width,
                       int channels, int quality, std::vector<uint8_t>* out);

}  // namespace mxhost
