// The CG loop's chunk graph, for NVIDIA Hopper (sm_90a).
//
// The counterpart of the JAX package's lax.while_loop and its residual
// lax.cond (plssvm_sparse_fp22_tpu/solver/cg.py:161-175, 247-269): a CUDA
// graph that runs up to `slots` CG iterations while the loop is active,
// with the refresh chosen on the device.  The graph is
//
//   a memset node that zeroes the chunk's slot counter;
//   a WHILE node (its handle 1 at each launch) whose body is one slot:
//     a one-thread kernel that reads the carry's `active` flag, `k` and the
//     counter, and sets three conditional handles: go = active && counter <
//     slots (the WHILE handle, so the loop ends at the first slot that does
//     not run), plain = go && k % R != R - 1, refresh = go && k % R == R - 1;
//     an IF node on `plain` whose body is the plain step's graph;
//     an IF node on `refresh` whose body is the refresh step's graph.
//
// The kernel sets all three handles before either body runs, so a slot runs
// at most one step even though the step itself moves `k`.  Once the loop
// has stopped, a launch runs the memset, one slot kernel and two empty IF
// nodes, and changes nothing (about 16 us on an H100, whatever `slots` is),
// which is what lets the host read the loop's state a chunk behind.
//
// The step graphs are captured by PyTorch (its allocator places their
// temporaries in a private pool) and handed over as cudaGraph_t; each IF
// body holds a child-graph node, a copy of one of them.  Conditional nodes,
// nested ones included, need CUDA 12.4 or later.
//
// The C entry points return a cudaError_t as int.  cg_chunk_build
// allocates the graph and its executable (freed by cg_chunk_destroy; CUDA
// frees an executable still in flight once it ends); cg_chunk_launch
// launches on the caller's stream and does not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void cg_slot(cudaGraphConditionalHandle loop, cudaGraphConditionalHandle plain,
                        cudaGraphConditionalHandle refresh, const bool* active,
                        const long long* k, long long interval, long long* slot,
                        long long slots) {
    const bool go = *active && *slot < slots;
    if (go) ++*slot;
    const bool due = *k % interval == interval - 1;
    cudaGraphSetConditional(plain, go && !due ? 1u : 0u);
    cudaGraphSetConditional(refresh, go && due ? 1u : 0u);
    cudaGraphSetConditional(loop, go ? 1u : 0u);
}

cudaError_t add_conditional(cudaGraph_t graph, cudaGraphNode_t* prev,
                            cudaGraphConditionalHandle handle, cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = type;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    const cudaError_t err = cudaGraphAddNode(&node, graph, prev, nullptr, 1, &params);
#else
    const cudaError_t err = cudaGraphAddNode(&node, graph, prev, 1, &params);
#endif
    if (err != cudaSuccess) return err;
    *prev = node;
    *body = params.conditional.phGraph_out[0];
    return cudaSuccess;
}

// An IF node after *prev whose body is a copy of `step`.
cudaError_t add_if_step(cudaGraph_t graph, cudaGraphNode_t* prev,
                        cudaGraphConditionalHandle handle, cudaGraph_t step) {
    cudaGraph_t body;
    const cudaError_t err = add_conditional(graph, prev, handle, cudaGraphCondTypeIf, &body);
    if (err != cudaSuccess) return err;
    cudaGraphNode_t child;
    return cudaGraphAddChildGraphNode(&child, body, nullptr, 0, step);
}

cudaError_t build(cudaGraph_t graph, cudaGraph_t plain, cudaGraph_t refresh,
                  const bool* active, const long long* k, long long interval, long long* slot,
                  long long slots) {
    cudaGraphConditionalHandle h_loop;
    cudaError_t err = cudaGraphConditionalHandleCreate(&h_loop, graph, 1,
                                                       cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return err;
    cudaMemsetParams reset = {};
    reset.dst = slot;
    reset.value = 0;
    reset.elementSize = 4;
    reset.width = 2;  // one int64
    reset.height = 1;
    cudaGraphNode_t prev;
    err = cudaGraphAddMemsetNode(&prev, graph, nullptr, 0, &reset);
    if (err != cudaSuccess) return err;
    cudaGraph_t body;
    err = add_conditional(graph, &prev, h_loop, cudaGraphCondTypeWhile, &body);
    if (err != cudaSuccess) return err;
    cudaGraphConditionalHandle h_plain, h_refresh;
    err = cudaGraphConditionalHandleCreate(&h_plain, body, 0, 0);
    if (err != cudaSuccess) return err;
    err = cudaGraphConditionalHandleCreate(&h_refresh, body, 0, 0);
    if (err != cudaSuccess) return err;
    void* args[] = {&h_loop, &h_plain, &h_refresh, &active, &k, &interval, &slot, &slots};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(cg_slot);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    err = cudaGraphAddKernelNode(&prev, body, nullptr, 0, &kp);
    if (err != cudaSuccess) return err;
    err = add_if_step(body, &prev, h_plain, plain);
    if (err != cudaSuccess) return err;
    return add_if_step(body, &prev, h_refresh, refresh);
}

}  // namespace

extern "C" {

// graph_out, exec_out = the chunk graph of up to `slots` >= 1 iterations
// over the step graphs `plain` and `refresh` (copied, so the caller may
// destroy them), reading the device's bool *active and int64 *k, counting
// in the device's int64 *slot; interval = R >= 1.
int cg_chunk_build(void* plain, void* refresh, const void* active, const void* k, void* slot,
                   long long interval, long long slots, void** graph_out, void** exec_out) {
    *graph_out = nullptr;
    *exec_out = nullptr;
    if (slots < 1 || interval < 1 || !plain || !refresh || !active || !k || !slot)
        return (int)cudaErrorInvalidValue;
    cudaGraph_t graph;
    cudaError_t err = cudaGraphCreate(&graph, 0);
    if (err != cudaSuccess) return (int)err;
    err = build(graph, static_cast<cudaGraph_t>(plain), static_cast<cudaGraph_t>(refresh),
                static_cast<const bool*>(active), static_cast<const long long*>(k), interval,
                static_cast<long long*>(slot), slots);
    cudaGraphExec_t exec = nullptr;
    if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
    if (err != cudaSuccess) {
        cudaGraphDestroy(graph);
        return (int)err;
    }
    *graph_out = graph;
    *exec_out = exec;
    return (int)cudaSuccess;
}

int cg_chunk_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                static_cast<cudaStream_t>(stream));
}

int cg_chunk_destroy(void* graph, void* exec) {
    cudaError_t err = cudaSuccess;
    if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
    if (graph) {
        const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
        if (err == cudaSuccess) err = e2;
    }
    return (int)err;
}

// The name of a cudaError_t, for the caller's message.
const char* cg_error_name(int err) { return cudaGetErrorName(static_cast<cudaError_t>(err)); }

}  // extern "C"
