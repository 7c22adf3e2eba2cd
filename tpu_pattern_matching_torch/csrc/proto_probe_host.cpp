// The prototype probe kernel's per-item code (proto_probe.cuh) run on the
// CPU over every item of a launch, in index order, each lane probed
// against its banks in turn (the kernel's bank queues order the same
// probes differently; a lane's result is the AND of its banks either
// way). Built with g++ (no CUDA needed), it lets the tests hold the
// kernel's arithmetic and item placement to the reference without a GPU.
// Same arguments and output as tpm_proto_probe, minus the stream, plus
// the words per item (1 or 4) that the kernel's entry point picks by the
// launch's size. Returns 0 or tpm::kBadArgs.
#include <stdint.h>

#include "proto_probe.cuh"

extern "C" int tpm_proto_probe_host(const void* data, const void* words,
                                    void* out, int tiles, int rows,
                                    int stride, int q, int pitch, int C,
                                    int kbanks, int v, const void* mix1,
                                    const void* mix2, int wpi) {
  tpm::ProbeParams p;
  tpm::ProtoGeom g;
  if (tpm::fill_proto(p, g, tiles, rows, stride, q, pitch, C, kbanks, v,
                      wpi, static_cast<const int64_t*>(mix1),
                      static_cast<const int64_t*>(mix2)))
    return tpm::kBadArgs;
  const auto* d = static_cast<const uint32_t*>(data);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  for (int item = 0; item < g.items; ++item)
    tpm::proto_item(d, w, p, g, item, o);
  return 0;
}
