// loop_cond: the condition of a compiled loop on the card, and the pass
// graph it drives: the prologue, the steps, each after the first behind a
// conditional node that this kernel opens, and the epilogue, in one
// cudaGraphLaunch (graphs.Graphs, through ops/loop_cond).
//
// Replaces no TPU kernel: the JAX package's lax.while_loop keeps its
// condition on the TPU, where XLA compiles cond and body into one
// program.  The port replays one CUDA graph per part, and without this
// kernel the host reads the loop's flag after every step (graphs.drive,
// graphs.drive_lanes) and launches the next replay only then, so the card
// waits for a read and a launch between steps.  Here the card evaluates
// the condition itself: a pass is one launch with no host read inside it.
//
// The rule is the host loops' (the plain twin, graphs.host_pass):
// * rule 0 (drive): after a step, run another while the state's done flag
//   (one bool) is clear;
// * rule 1 (drive_lanes): while left[0] (an int64, the lanes still
//   running) is above 0;
// and at most cap steps.  The first step runs before any test, as in the
// host loops, where the first step is never preceded by a read.
//
// The shape of the pass graph: its one node is an IF node whose handle
// defaults to 1 at every launch, so the host launches one node and the
// card runs the pass from its body: the prologue, step 1 and this kernel,
// then a chain of IF nodes, each nested in the body of the one before, and
// the epilogue.  The body of IF node k holds step k (a child graph node
// cloned from the one captured step), this kernel, and IF node k + 1; the
// kernel after step k sets IF node k + 1's handle, and the kernel after
// step cap sets none.  (With the prologue and epilogue at the top level,
// the host's launch took 43-45 instead of 16-22 us, and the pass 28 us
// more of the card's time, where this shape took 3 us more than the three
// parts replayed back to back: the map loop at 5.4M points, one step a
// pass, on an H100.)  A single WHILE node over one body would do the same
// with one copy of the step, and about 30 us more of the card's time a
// pass; and the profiler (CUPTI, with the driver 580 and torch 2.11 on an
// H100) reports each node of a WHILE body once per launch, with the last
// iteration's times, so a profile could neither count nor time the steps
// of a pass.  Each step here is a node of its own, and each step that runs
// is reported.  Cloning costs instantiation time (about 0.2 s for 30 steps
// of 234 nodes), not captures: the step is captured once; graphs.PASS_OPS
// bounds a pass graph's size.
//
// What bounds the kernel: nothing of the card's; one thread reads one flag
// and adds one to the configuration's step count, which the host reads
// only when a launch counter is read (graphs.settle), never inside a call.
#include <cuda_runtime.h>

namespace {

__global__ void loop_cond_kernel(cudaGraphConditionalHandle next, int last,
                                 const void* flag, int rule,
                                 unsigned long long* steps) {
  steps[0] += 1ull;
  if (last) return;
  const bool running =
      rule == 0 ? !*static_cast<const bool*>(flag)
                : *static_cast<const long long*>(flag) > 0;
  cudaGraphSetConditional(next, running ? 1u : 0u);
}

}  // namespace

// An IF node with ``handle`` in ``graph``, after ``after`` where it is
// not null; *body receives its body graph.
cudaError_t add_if(cudaGraph_t graph, cudaGraphNode_t after,
                   cudaGraphConditionalHandle handle, cudaGraphNode_t* node,
                   cudaGraph_t* body) {
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaError_t err =
      cudaGraphAddNode(node, graph, after ? &after : nullptr, after ? 1 : 0,
                       &params);
  if (err == cudaSuccess) *body = params.conditional.phGraph_out[0];
  return err;
}

#define DCREG_TRY(call)                                   \
  do {                                                    \
    cudaError_t err_ = (call);                            \
    if (err_ != cudaSuccess) {                            \
      cudaGraphDestroy(graph);                            \
      return static_cast<int>(err_);                      \
    }                                                     \
  } while (0)

// The pass graph of one configuration and cap, instantiated on device
// ``device``: in one IF body, the prologue, the cap steps with their
// conditions (steps 2 to cap each in the body of an IF node nested in the
// one before), the epilogue; each part a child graph node cloned from its
// captured graph.  *exec_out receives the cudaGraphExec_t.  Returns a
// cudaError.
extern "C" int dcreg_loop_pass(void* prologue, void* step, void* epilogue,
                               const void* flag, int rule, int cap,
                               unsigned long long* steps, int device,
                               void** exec_out) {
  if ((rule != 0 && rule != 1) || cap < 1 || flag == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library's runtime keeps a current device of its own
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t graph = nullptr;
  err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphConditionalHandle handle;
  DCREG_TRY(cudaGraphConditionalHandleCreate(&handle, graph, 1u,
                                             cudaGraphCondAssignDefault));
  cudaGraph_t pass;
  cudaGraphNode_t node, pro, epi;
  DCREG_TRY(add_if(graph, nullptr, handle, &node, &pass));
  DCREG_TRY(cudaGraphAddChildGraphNode(&pro, pass, nullptr, 0,
                                       static_cast<cudaGraph_t>(prologue)));
  // ``parent`` holds step k; ``tail`` is the pass body's last node
  cudaGraph_t parent = pass;
  cudaGraphNode_t after = pro, tail = pro;
  for (int k = 1; k <= cap; ++k) {
    if (k > 1) {
      DCREG_TRY(add_if(parent, after, handle, &node, &parent));
      if (k == 2) tail = node;
      after = nullptr;
    }
    cudaGraphNode_t body_step, cond;
    DCREG_TRY(cudaGraphAddChildGraphNode(&body_step, parent,
                                         after ? &after : nullptr,
                                         after ? 1 : 0,
                                         static_cast<cudaGraph_t>(step)));
    int last = k == cap;
    if (!last)  // set by this step's condition kernel at every launch
      DCREG_TRY(cudaGraphConditionalHandleCreate(&handle, parent, 0u, 0u));
    void* args[] = {&handle, &last, &flag, &rule, &steps};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(loop_cond_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    DCREG_TRY(cudaGraphAddKernelNode(&cond, parent, &body_step, 1, &kp));
    if (k == 1) tail = cond;
    after = cond;
  }
  DCREG_TRY(cudaGraphAddChildGraphNode(&epi, pass, &tail, 1,
                                       static_cast<cudaGraph_t>(epilogue)));
  cudaGraphExec_t exec = nullptr;
  DCREG_TRY(cudaGraphInstantiate(&exec, graph, 0));
  cudaGraphDestroy(graph);
  *exec_out = exec;
  return 0;
}

// One pass: launch the instantiated pass graph on the stream.
extern "C" int dcreg_loop_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

// Free a pass graph (a pass still in flight completes first).
extern "C" int dcreg_loop_free(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}
