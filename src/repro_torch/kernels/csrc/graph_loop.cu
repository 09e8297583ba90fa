// Device-side loop of the fused executor's linear-tail fixpoint: the
// counterpart of the reference's `lax.while_loop` (src/repro/engine/fused.py,
// `_build_fixpoint`), which keeps a whole linear phase on the device and
// hands the host one result per exit.
//
// The Python side captures ONE loop iteration with PyTorch's CUDA graph
// capture (torch.cuda.CUDAGraph(keep_graph=True)).  The iteration reads the
// loop state from fixed buffers, writes the next state back into them, and
// ends by writing `cont` (live deltas, no overflow, rounds below the cap)
// into one device int32.  This file builds the graph around it: an outer
// graph with a conditional WHILE node (CUDA >= 12.4) whose body is a child
// graph node holding a copy of the captured iteration, followed by a
// one-thread kernel that sets the node's condition from `cont`.  The
// condition starts at 1 on every launch, so the body runs at least once;
// the caller launches only when the loop's condition holds on entry.
//
// Bound: none of its own.  The set-condition kernel reads 4 bytes per
// iteration; the iterations' kernels are the engine's.  What the node
// removes is the host: one graph launch per phase instead of one launch
// and one blocking pull per round.
#include "common.cuh"

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const int32_t* cont) {
    cudaGraphSetConditional(handle, *cont != 0 ? 1u : 0u);
}

#define RT_TRY(call)                              \
    do {                                          \
        err = (call);                             \
        if (err != cudaSuccess) goto fail;        \
    } while (0)

// body: the captured iteration (a cudaGraph_t; it is copied, not kept);
// cont: device int32 written by the iteration.  On success *graph_out and
// *exec_out hold the outer graph and its instantiation.
extern "C" int rt_while_graph_create(void* body, const void* cont,
                                     void** graph_out, void** exec_out) {
    cudaError_t err = cudaSuccess;
    cudaGraph_t outer = nullptr;
    cudaGraphExec_t exec = nullptr;
    cudaGraphConditionalHandle handle;
    cudaGraphNodeParams params = {};
    cudaGraphNode_t loop, child, setter;
    cudaGraph_t loop_body;
    cudaKernelNodeParams kp = {};
    const int32_t* cont_i = (const int32_t*)cont;
    void* args[] = {&handle, &cont_i};

    RT_TRY(cudaGraphCreate(&outer, 0));
    RT_TRY(cudaGraphConditionalHandleCreate(&handle, outer, 1,
                                            cudaGraphCondAssignDefault));
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
#if CUDART_VERSION >= 13000
    RT_TRY(cudaGraphAddNode(&loop, outer, nullptr, nullptr, 0, &params));
#else
    RT_TRY(cudaGraphAddNode(&loop, outer, nullptr, 0, &params));
#endif
    loop_body = params.conditional.phGraph_out[0];
    RT_TRY(cudaGraphAddChildGraphNode(&child, loop_body, nullptr, 0,
                                      (cudaGraph_t)body));
    kp.func = (void*)set_condition_kernel;
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.sharedMemBytes = 0;
    kp.kernelParams = args;
    RT_TRY(cudaGraphAddKernelNode(&setter, loop_body, &child, 1, &kp));
    RT_TRY(cudaGraphInstantiate(&exec, outer, 0));
    *graph_out = (void*)outer;
    *exec_out = (void*)exec;
    return 0;
fail:
    if (outer) cudaGraphDestroy(outer);
    return (int)err;
}

extern "C" int rt_graph_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int rt_graph_destroy(void* graph, void* exec) {
    cudaError_t err = cudaSuccess;
    if (exec) err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
    if (graph) {
        const cudaError_t e2 = cudaGraphDestroy((cudaGraph_t)graph);
        if (err == cudaSuccess) err = e2;
    }
    return (int)err;
}
