// Device-side launch of a captured CUDA graph: the trainers' dispatch of a
// chunk of train steps, or of a validation pass, as host calls that return
// at once (train/chunks.py).
//
// JAX runs a chunk as one XLA program and launches it as one asynchronous
// call (betavae_tpu/train/loop.py: make_train_multi_step, dispatch_chunk).
// The port captures one train step (about 820 kernels) and launches it
// once a step.  A host launch of it returns only once the launch queue has
// room for the graph's work: behind a running chunk, 182 host launches of
// the step hold the host until the device has run most of them
// (chip_smoke.py, phase scan_chunks, one_launch).
//
// A graph launched from the device does not go through that queue.  The
// target graph is instantiated for device launch and uploaded once; the
// host then launches a one-node graph whose kernel tail-launches the
// target.  The host's call queues that one node and returns.  A tail launch
// starts when the launching kernel's work is done and belongs to the
// launching graph's execution environment, so the host stream's next work
// starts only once the target graph has run: stream order holds as with a
// host launch.
//
// Interface (plain C, bound with ctypes), each returning 0 or a code
// 1000 * stage + cudaError_t:
//
//   betavae_graph_device_instantiate(graph, &target, &launcher)
//       graph: a captured cudaGraph_t (kept by its owner; not modified).
//       Instantiates it for device launch (target), uploads it, and builds
//       and uploads the one-kernel launcher graph (launcher).
//   betavae_graph_launch(launcher, stream)
//       Launches the launcher graph on stream (one host call).
//   betavae_graph_destroy(target, launcher)
//       Waits for the device, then destroys both executable graphs.
//
// A failed tail launch inside the kernel traps, which makes the next
// synchronising call of the context fail: a chunk that did not run is
// never read as if it had.

#include <cuda_runtime.h>

namespace {

__global__ void tail_launch(cudaGraphExec_t target) {
  if (cudaGraphLaunch(target, cudaStreamGraphTailLaunch) != cudaSuccess) {
    __trap();
  }
}

int code(int stage, cudaError_t rc) {
  return rc == cudaSuccess ? 0 : 1000 * stage + static_cast<int>(rc);
}

}  // namespace

extern "C" {

int betavae_graph_device_instantiate(void* graph, void** target_out,
                                     void** launcher_out) {
  cudaStream_t stream;
  cudaError_t rc = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  if (rc != cudaSuccess) return code(1, rc);
  cudaGraphExec_t target = nullptr, launcher = nullptr;
  cudaGraph_t one = nullptr;
  int out = 0;
  rc = cudaGraphInstantiate(&target, static_cast<cudaGraph_t>(graph),
                            cudaGraphInstantiateFlagDeviceLaunch);
  if (rc != cudaSuccess) { out = code(2, rc); goto done; }
  rc = cudaGraphUpload(target, stream);
  if (rc != cudaSuccess) { out = code(3, rc); goto done; }
  rc = cudaStreamBeginCapture(stream, cudaStreamCaptureModeThreadLocal);
  if (rc != cudaSuccess) { out = code(4, rc); goto done; }
  tail_launch<<<1, 1, 0, stream>>>(target);
  rc = cudaGetLastError();
  {
    cudaError_t end = cudaStreamEndCapture(stream, &one);
    if (rc == cudaSuccess) rc = end;
  }
  if (rc != cudaSuccess) { out = code(5, rc); goto done; }
  rc = cudaGraphInstantiate(&launcher, one, 0);
  if (rc != cudaSuccess) { out = code(6, rc); goto done; }
  rc = cudaGraphUpload(launcher, stream);
  if (rc != cudaSuccess) { out = code(7, rc); goto done; }
  rc = cudaStreamSynchronize(stream);
  if (rc != cudaSuccess) { out = code(8, rc); goto done; }
done:
  if (one != nullptr) cudaGraphDestroy(one);
  cudaStreamDestroy(stream);
  if (out != 0) {
    if (launcher != nullptr) cudaGraphExecDestroy(launcher);
    if (target != nullptr) cudaGraphExecDestroy(target);
    return out;
  }
  *target_out = target;
  *launcher_out = launcher;
  return 0;
}

int betavae_graph_launch(void* launcher, void* stream) {
  return code(1, cudaGraphLaunch(static_cast<cudaGraphExec_t>(launcher),
                                 static_cast<cudaStream_t>(stream)));
}

int betavae_graph_destroy(void* target, void* launcher) {
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc != cudaSuccess) return code(1, rc);
  rc = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(launcher));
  if (rc != cudaSuccess) return code(2, rc);
  return code(3, cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(target)));
}

}  // extern "C"
