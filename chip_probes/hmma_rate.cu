// The rate of mma.sync.m16n8k16 (bf16 in, f32 accumulate) on one card:
// each warp runs CH independent accumulator chains for 4,096 steps, at 4
// to 32 warps an SM; prints TFLOP/s and cycles an mma a scheduler at the
// clock given (default 1.755 GHz; read it with nvidia-smi beside the run).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o hmma_rate \
//       chip_probes/hmma_rate.cu && ./hmma_rate [clock_ghz]
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstdio>
#include <cstdlib>

template <int CH>
__global__ void bench(float* out, int iters, uint32_t seed) {
  float c[CH][4] = {};
  const uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3, a2 = a0 * 5,
                 a3 = a0 * 7, b0 = a0 * 11, b1 = a0 * 13;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < CH; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.0f;
  for (int k = 0; k < CH; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  if (s == 1.2345f) out[0] = s;    // keeps the chains live
}

template <int CH>
void run(int warps_per_sm, int sms, double ghz) {
  float* out;
  cudaMalloc(&out, 4);
  const int iters = 4096, blocks = sms * warps_per_sm / 4;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  bench<CH><<<blocks, 128>>>(out, iters, 1);
  cudaDeviceSynchronize();
  cudaEventRecord(e0);
  bench<CH><<<blocks, 128>>>(out, iters, 2);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double mmas = (double)CH * iters * blocks * 4;
  printf("chains=%d warps/SM=%d ms=%.3f TFLOP/s=%.1f cycles/mma/scheduler=%.2f\n",
         CH, warps_per_sm, ms, 4096.0 * mmas / ms / 1e9,
         ms * 1e-3 * ghz * 1e9 / (mmas / (sms * 4)));
  cudaFree(out);
}

int main(int argc, char** argv) {
  const double ghz = argc > 1 ? atof(argv[1]) : 1.755;
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  for (int w : {4, 8, 12, 16, 32}) {
    run<4>(w, sms, ghz);
    run<8>(w, sms, ghz);
  }
  return 0;
}
