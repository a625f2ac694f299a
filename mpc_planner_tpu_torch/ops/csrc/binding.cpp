// PyTorch binding of the Hopper kernels: the only source that includes
// PyTorch's headers. Each function launches one kernel on the current
// stream and checks the launch; the Python wrappers in ops/cuda_qp.py
// validate devices, dtypes, shapes and contiguity before calling here.

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/extension.h>

#include "kernels.h"

namespace {

void check_cuda_f32(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void mirror(const torch::Tensor& H, torch::Tensor out, double lm, int64_t sweeps) {
  check_cuda_f32(H, "H");
  check_cuda_f32(out, "out");
  TORCH_CHECK(H.dim() == 3 && H.size(1) == H.size(2), "H must be [M, n, n]");
  TORCH_CHECK(out.sizes() == H.sizes(), "out must match H");
  const c10::cuda::CUDAGuard guard(H.device());
  const cudaError_t err = launch_mirror(
      H.data_ptr<float>(), out.data_ptr<float>(), H.size(0), static_cast<int>(H.size(1)),
      static_cast<float>(lm), static_cast<int>(sweeps), c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "mirror kernel: ", cudaGetErrorString(err), " (n=", H.size(1), ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void qp(const std::vector<torch::Tensor>& inputs, const std::vector<torch::Tensor>& outputs,
        int64_t N, int64_t nu, int64_t nx, int64_t nh,
        int64_t iterations, double mu0, double reg, double tau, bool use_warm, bool mehrotra,
        double sigma_fixed) {
  // inputs: H, g, A, Bm, c, Dh, lb, ub, wl, wu, wok; outputs: dz, lam_l, lam_u, mu
  TORCH_CHECK(inputs.size() == 11 && outputs.size() == 4, "qp: 11 inputs and 4 outputs");
  for (const auto& t : inputs) check_cuda_f32(t, "qp input");
  for (const auto& t : outputs) check_cuda_f32(t, "qp output");
  const int64_t B = outputs[3].numel();
  const c10::cuda::CUDAGuard guard(inputs[0].device());
  QPLaunch a;
  a.H = inputs[0].data_ptr<float>();
  a.g = inputs[1].data_ptr<float>();
  a.A = inputs[2].data_ptr<float>();
  a.Bm = inputs[3].data_ptr<float>();
  a.c = inputs[4].data_ptr<float>();
  a.Dh = inputs[5].data_ptr<float>();
  a.lb = inputs[6].data_ptr<float>();
  a.ub = inputs[7].data_ptr<float>();
  a.wl = inputs[8].data_ptr<float>();
  a.wu = inputs[9].data_ptr<float>();
  a.wok = inputs[10].data_ptr<float>();
  a.dz = outputs[0].data_ptr<float>();
  a.lam_l = outputs[1].data_ptr<float>();
  a.lam_u = outputs[2].data_ptr<float>();
  a.mu = outputs[3].data_ptr<float>();
  a.B = static_cast<int>(B);
  a.N = static_cast<int>(N);
  a.nu = static_cast<int>(nu);
  a.nx = static_cast<int>(nx);
  a.nh = static_cast<int>(nh);
  a.iterations = static_cast<int>(iterations);
  a.mu0 = static_cast<float>(mu0);
  a.reg = static_cast<float>(reg);
  a.tau = static_cast<float>(tau);
  a.sigma_fixed = static_cast<float>(sigma_fixed);
  a.use_warm = use_warm ? 1 : 0;
  a.mehrotra = mehrotra ? 1 : 0;
  const cudaError_t err = launch_qp(a, c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == cudaSuccess, "qp kernel: ", cudaGetErrorString(err), " (nu=", nu, ", nx=", nx, ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("mirror", &mirror, "MIRROR regularization of [M, n, n] symmetric matrices");
  m.def("qp", &qp, "Interior-point Riccati QP solve, element-major layout");
  m.def("qp_shared_bytes", &qp_shared_bytes,
        "dynamic shared memory per block (one element), without or with the QP staged");
  m.def("qp_resident_blocks", &qp_resident_blocks,
        "one-warp blocks of that much shared memory the device holds at once");
}
