// cuTensorMapEncodeTiled for the kernels that copy by TMA (K4 / K6
// window_attn.cu, K7 flash_attn.cu), looked up once through the CUDA
// runtime's entry-point query: the library links only the runtime, not
// libcuda.  MapCache keeps encoded maps for launches that repeat.
#pragma once

#include <array>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace nunif {

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

// the looked-up function; err is the lookup's error
struct Encoder {
  EncodeTiled fn = nullptr;
  cudaError_t err = cudaSuccess;
};

inline const Encoder& encoder() {
  static const Encoder enc = [] {
    Encoder e;
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult status = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    e.err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                             cudaEnableDefault, &status);
#else
    e.err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &status);
#endif
    if (e.err == cudaSuccess && (status != cudaDriverEntryPointSuccess || fn == nullptr))
      e.err = cudaErrorSymbolNotFound;
    e.fn = reinterpret_cast<EncodeTiled>(fn);
    return e;
  }();
  return enc;
}

// A per-thread cache of encoded maps, keyed on every input of the encoding
// (the address, extents, strides, box): a map is a function of its key
// alone, so a hit is exactly the map that encoding again would give,
// whatever tensor now lies at that address.  Slots are replaced in turn.
template <int KeyLen, int Slots = 16>
class MapCache {
 public:
  using Key = std::array<long long, KeyLen>;

  // the map for key into *map, by encode(map) (0 or an error code) on a
  // miss; a failed encoding is not kept
  template <class Encode>
  int get(const Key& key, CUtensorMap* map, Encode encode) {
    for (int i = 0; i < used_; ++i)
      if (keys_[i] == key) {
        *map = maps_[i];
        return 0;
      }
    const int rc = encode(map);
    if (rc != 0) return rc;
    keys_[next_] = key;
    maps_[next_] = *map;
    next_ = (next_ + 1) % Slots;
    if (used_ < Slots) ++used_;
    return 0;
  }

 private:
  Key keys_[Slots];
  CUtensorMap maps_[Slots];
  int used_ = 0, next_ = 0;
};

}  // namespace nunif
