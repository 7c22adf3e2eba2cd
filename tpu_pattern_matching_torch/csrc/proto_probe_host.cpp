// The prototype probe kernel's per-thread code (proto_probe.cuh) run on
// the CPU over every item of a launch, in index order. Built with g++ (no
// CUDA needed), it lets the tests hold the kernel's arithmetic to the
// reference without a GPU. Same arguments and output as tpm_proto_probe,
// minus the stream. Returns 0 or tpm::kBadArgs.
#include <stdint.h>

#include "proto_probe.cuh"

extern "C" int tpm_proto_probe_host(const void* data, const void* words,
                                    void* out, int tiles, int rows,
                                    int stride, int q, int pitch, int C,
                                    int kbanks, int v, const void* mix1,
                                    const void* mix2) {
  tpm::ProbeParams p;
  tpm::ProtoGeom g;
  if (tpm::fill_proto(p, g, tiles, rows, stride, q, pitch, C, kbanks, v,
                      static_cast<const int64_t*>(mix1),
                      static_cast<const int64_t*>(mix2)))
    return tpm::kBadArgs;
  const auto* d = static_cast<const uint32_t*>(data);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  for (int item = 0; item < g.items; ++item)
    o[item] = tpm::proto_item(d, w, p, g, item);
  return 0;
}
