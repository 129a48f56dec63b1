// The emulated kernels' dynamic shared memory (blocks run one at a time).
#include "mma.cuh"

namespace lameness {
__align__(16) unsigned char mma_smem[kEmuSharedBytes];
float smem[kEmuSharedBytes / sizeof(float)];
}  // namespace lameness
