// The fp16 instances of the mega kernels of mega_decode.cu (TPU kernel rows
// 13 and 14, paddle_tpu/ops/pallas/mega_decode.py::_mega_attn_kernel and
// ::_mega_mlp_kernel): the same source built as a library of its own, so
// its nvcc runs beside the fp32 / bf16 one; ops/mega_decode.py loads it for
// fp16 activations.
#define PTT_MEGA_F16 1
#include "mega_decode.cu"
