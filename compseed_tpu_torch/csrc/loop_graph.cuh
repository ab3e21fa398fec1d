// A segment's round loop as one CUDA graph, shared by the round sources
// chain_scan.cu (chain_scan) and walk_chain.cu (walk_pool_chain); fm_walk.cu
// runs the suffix-array walk's last stage the same way (its graph
// entries, retire_last for the walk's folded loop test), and lockstep.cu
// each stage of the lockstep walk (walk_stage).
//
// In the JAX package each segment of both loops is a jax.lax.while_loop
// (compseed_tpu/ops/seedscan.py:1726 and :734-738): the TPU tests the
// condition rnd < RCAP && sum(alive) > nxtw itself and the host waits on
// nothing inside a call.  Here the loop is a graph with a WHILE
// conditional node (CUDA 12.4 and later): the segment's entry kernel
// (compact.cuh: the lanes compacted from the previous segment, or counted
// before a call's first) sets the node's condition from the live count
// the segment starts with, and the body (a round's launches, captured
// from the caller's stream) ends with the round's apply kernel, whose
// last block to retire (one 64-bit atomic a block: the blocks retired and
// their live lanes) counts the round and sets the condition again
// (loop_retire).  No kernel of its own ends a round or starts a segment:
// the condition is set by the kernel that produces the count it tests.
// The host launches the graph once a segment and never reads the live
// count.
//
// loop_test is the condition itself, loop_go its step on a source's Args
// (its words nxtw, rcap, hist and go), loop_step a round's step after its
// apply (the words rnd, sc and the above), for the host loops;
// loop_retire is the apply's end that runs it on the card.  The graph is
// built by stream capture, as PyTorch builds its own conditional nodes:
// the outer graph is captured from one non-blocking stream (the entry
// kernel), the WHILE node is added after what that capture holds so far,
// and its body graph is captured from a second stream; both captures are
// thread-local, so launches of other threads (the alignment tail's DP
// beside the seeding worker) stay out of them.
// A body must not allocate: the graph names the addresses it was captured
// with until it is destroyed (ops/cuda_lib.py guards every capture).
//
// A loop may also join a capture already in progress on the caller's
// stream (the seeder's whole call as one graph, ops/cuda_lib.CallGraph):
// nest() creates the condition handle in that capture's graph, the entry
// kernel is captured from the caller's stream, body() adds the WHILE node
// after what that capture holds so far, and end() ends the body's capture
// alone: the enclosing capture instantiates and launches the loop with
// everything else it holds.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define LG_HD __host__ __device__ __forceinline__
#else
#define LG_HD inline
#endif

// Whether round `rnd` of a segment runs: rnd < rcap && live > nxtw, the
// JAX loop's cond; when it does and `hist` is given (chain_scan's
// report_rounds), hist[rnd] = live, the live lanes before the round.
LG_HD bool loop_test(int32_t rnd, int32_t live, long long nxtw,
                     long long rcap, int32_t* hist) {
  const bool go = rnd < rcap && live > nxtw;
  if (go && hist) hist[rnd] = live;
  return go;
}

// The loop's test on round `rnd` with `live` live lanes: go, also left in
// *go (and the histogram word: loop_test).
template <typename A>
LG_HD bool loop_go(const A& a, int32_t rnd, int32_t live) {
  const bool go = loop_test(rnd, live, a.nxtw, a.rcap, (int32_t*)a.hist);
  *(int32_t*)a.go = go ? 1 : 0;
  return go;
}

// The loop's step after a round: the round counter was `rnd` and the
// round leaves `live` live lanes, stored in the int32 word sc[kLive] of
// the source's Args `a`; the round counted, then loop_go.
template <int kLive, typename A>
LG_HD bool loop_after(const A& a, int32_t rnd, int32_t live) {
  *(int32_t*)a.rnd = rnd + 1;
  ((int32_t*)a.sc)[kLive] = live;
  return loop_go(a, rnd + 1, live);
}

// The loop's step after a round on a round source's Args `a` (its words
// rnd, nxtw, rcap, hist, go, sc), whose int32 word sc[kLive] holds the
// live count the round left (the host loops'): loop_after on the words
// as they stand.  Returns whether the next round runs.
template <int kLive, typename A>
LG_HD bool loop_step(const A& a) {
  return loop_after<kLive>(a, *(const int32_t*)a.rnd,
                           ((const int32_t*)a.sc)[kLive]);
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

// The WHILE node's condition set inside a graph (a.cond: its handle, 0
// outside one).
template <typename A>
__device__ __forceinline__ void loop_cond(const A& a, bool go) {
  if (a.cond) cudaGraphSetConditional((cudaGraphConditionalHandle)a.cond, go);
}

// What the last block of a round's apply needs of the words before the
// round, read by thread 0 of every block at the kernel's start when a.loop
// is set (off the last block's path): the round counter and the live count
// (0 after the round's first kernel reset it).  No block writes either
// word before the last block to retire, so that block's own reads hold.
struct LoopPre {
  int32_t rnd, live;
};

template <int kLive, typename A>
__device__ __forceinline__ LoopPre loop_pre(const A& a) {
  LoopPre p{0, 0};
  if (a.loop && threadIdx.x == 0) {
    p.rnd = *(const int32_t*)a.rnd;
    p.live = ((const int32_t*)a.sc)[kLive];
  }
  return p;
}

// The count of a launch's blocks as they retire: every thread of every
// block calls with its lane's live count (1 or 0).  The block sums them,
// and one thread adds 2^32 + that sum to the 64-bit word `word` (8-byte
// aligned, 0 between launches) in one atomic: its high half counts the
// blocks that retired, its low half their live lanes.  The block whose
// add finds n_blocks - 1 retired is the last, and the value the atomic
// returns already holds every other block's count, so it needs no fence
// and no second read: its thread 0 gets true and *total, the launch's
// live lanes, and resets the word for the next launch; every other
// thread gets false.  (The ticket of a look-back is no such proof: the
// block that draws it is the last to start, and blocks that started
// before it may still be adding.)  kWarps: the block's warps.
template <int kWarps>
__device__ __forceinline__ bool retire_last(unsigned long long* word,
                                            int live, int n_blocks,
                                            int* total) {
  __shared__ int sums[kWarps];
  const int s = __reduce_add_sync(0xFFFFFFFFu, live);
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x != 0) return false;
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += sums[w];
  const unsigned long long old = atomicAdd(word, (1ull << 32) | (unsigned)t);
  if ((int)(old >> 32) != n_blocks - 1) return false;
  *total = (int)(unsigned)old + t;
  *word = 0;
  return true;
}

// The end of a round's last kernel (the apply) when a.loop says it ends a
// loop's body; nothing otherwise.  Every thread of every block calls it
// with its lane's live count (the apply then adds none to sc[kLive]
// itself), counted as the blocks retire in the 64-bit word at sc[kRetire]
// (retire_last); the last block runs loop_after (the round counted,
// sc[kLive] = pre.live + the round's live lanes, the test) and sets the
// condition.
template <int kLive, int kRetire, int kWarps, typename A>
__device__ __forceinline__ void loop_retire(const A& a, int live,
                                            int n_blocks, LoopPre pre) {
  if (!a.loop) return;
  int total;
  if (retire_last<kWarps>(
          (unsigned long long*)((int32_t*)a.sc + kRetire), live, n_blocks,
          &total))
    loop_cond(a, loop_after<kLive>(a, pre.rnd, pre.live + total));
}

namespace loop_graph {

// One segment's graph as it is built and run.  `open` counts the captures
// in progress: 1 the outer graph, 2 its body too.  `nested`: the outer
// capture is the caller's (nest), which this state neither ends nor
// instantiates.
struct State {
  cudaStream_t outer, child;
  cudaGraph_t graph, body;
  cudaGraphExec_t exec;
  int open;
  bool nested;
};

// Start capturing the outer graph from `outer`; *handle gets the WHILE
// node's condition handle, created in that graph (the entry kernel and
// the body's last kernel take it as an argument, so it exists before they
// are captured).
inline int begin(State* s, cudaStream_t outer, cudaStream_t child,
                 unsigned long long* handle) {
  *s = State{outer, child, nullptr, nullptr, nullptr, 0, false};
  cudaError_t e =
      cudaStreamBeginCapture(outer, cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  s->open = 1;
  cudaStreamCaptureStatus status;
  cudaGraph_t g;
  e = cudaStreamGetCaptureInfo(outer, &status, nullptr, &g, nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  *handle = (unsigned long long)h;
  return (int)e;
}

// Join the capture in progress on `stream` (the caller's, thread-local or
// global): *handle gets the WHILE node's condition handle, created in that
// capture's graph.  Fails unless `stream` is capturing.
inline int nest(State* s, cudaStream_t stream, cudaStream_t child,
                unsigned long long* handle) {
  *s = State{stream, child, nullptr, nullptr, nullptr, 0, true};
  cudaStreamCaptureStatus status;
  cudaGraph_t g;
  cudaError_t e =
      cudaStreamGetCaptureInfo(stream, &status, nullptr, &g, nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorIllegalState;
  s->open = 1;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  *handle = (unsigned long long)h;
  return (int)e;
}

// Add the WHILE node after everything captured from `outer` so far, make
// it the capture's only dependency, and start capturing its body graph
// from the child stream.
inline int body(State* s, unsigned long long handle) {
  cudaStreamCaptureStatus status;
  cudaGraph_t g;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = cudaStreamGetCaptureInfo(s->outer, &status, nullptr, &g,
                                           &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = (cudaGraphConditionalHandle)handle;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, g, deps, n_deps, &p);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s->outer, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  s->body = p.conditional.phGraph_out[0];
  e = cudaStreamBeginCaptureToGraph(s->child, s->body, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return (int)e;
  s->open = 2;
  return 0;
}

// The nodes of the body graph by type, what the card runs every round:
// out[0] kernels, out[1] memsets, out[2] any other.
inline int body_nodes(const State* s, int* out) {
  out[0] = out[1] = out[2] = 0;
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(s->body, nullptr, &n);
  if (e != cudaSuccess || n == 0) return (int)e;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  e = cudaGraphGetNodes(s->body, nodes, &n);
  for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(nodes[i], &t);
    ++out[t == cudaGraphNodeTypeKernel   ? 0
          : t == cudaGraphNodeTypeMemset ? 1
                                         : 2];
  }
  delete[] nodes;
  return (int)e;
}

// End both captures and instantiate the outer graph (the body graph
// belongs to its node); a nested loop's body capture alone.
inline int end(State* s) {
  cudaGraph_t g;
  cudaError_t e = cudaStreamEndCapture(s->child, &g);
  s->open = 1;
  if (e != cudaSuccess) return (int)e;
  if (s->nested) {
    s->open = 0;
    return 0;
  }
  e = cudaStreamEndCapture(s->outer, &s->graph);
  s->open = 0;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGraphInstantiate(&s->exec, s->graph, 0);
}

// Free the graph: captures still open (a failed build) are ended first,
// the caller's own capture of a nested loop excepted.  An exec still
// running on the card is destroyed when it has finished.
inline void close(State* s) {
  cudaGraph_t g = nullptr;
  if (s->open == 2) cudaStreamEndCapture(s->child, &g);
  g = nullptr;
  if (s->open >= 1 && !s->nested &&
      cudaStreamEndCapture(s->outer, &g) == cudaSuccess && g)
    cudaGraphDestroy(g);
  if (s->exec) cudaGraphExecDestroy(s->exec);
  if (s->graph) cudaGraphDestroy(s->graph);
  *s = State{};
  cudaGetLastError();                 // a failed capture's sticky code
}

}  // namespace loop_graph

// The C entries of a source's loop graphs, named <prefix>_graph_*:
// streams (two non-blocking streams on the current device, for captures),
// begin, nest, body, end, launch (on a stream), nodes (body_nodes) and
// close.  Each returns the CUDA error code, close nothing.
#define LOOP_GRAPH_ENTRIES(prefix)                                          \
  extern "C" int prefix##_graph_streams(void** outer, void** child) {       \
    cudaError_t e = cudaStreamCreateWithFlags((cudaStream_t*)outer,         \
                                              cudaStreamNonBlocking);       \
    if (e != cudaSuccess) return (int)e;                                    \
    return (int)cudaStreamCreateWithFlags((cudaStream_t*)child,             \
                                          cudaStreamNonBlocking);           \
  }                                                                         \
  extern "C" int prefix##_graph_begin(void* outer, void* child,             \
                                      void** state,                         \
                                      unsigned long long* handle) {         \
    auto* s = new loop_graph::State{};                                      \
    *state = s;                                                             \
    return loop_graph::begin(s, (cudaStream_t)outer, (cudaStream_t)child,   \
                             handle);                                       \
  }                                                                         \
  extern "C" int prefix##_graph_nest(void* stream, void* child,             \
                                     void** state,                          \
                                     unsigned long long* handle) {          \
    auto* s = new loop_graph::State{};                                      \
    *state = s;                                                             \
    return loop_graph::nest(s, (cudaStream_t)stream, (cudaStream_t)child,   \
                            handle);                                        \
  }                                                                         \
  extern "C" int prefix##_graph_body(void* state,                           \
                                     unsigned long long handle) {           \
    return loop_graph::body((loop_graph::State*)state, handle);             \
  }                                                                         \
  extern "C" int prefix##_graph_end(void* state) {                          \
    return loop_graph::end((loop_graph::State*)state);                      \
  }                                                                         \
  extern "C" int prefix##_graph_launch(void* state, void* stream) {         \
    return (int)cudaGraphLaunch(((loop_graph::State*)state)->exec,          \
                                (cudaStream_t)stream);                      \
  }                                                                         \
  extern "C" int prefix##_graph_nodes(void* state, int* out) {              \
    return loop_graph::body_nodes((loop_graph::State*)state, out);          \
  }                                                                         \
  extern "C" void prefix##_graph_close(void* state) {                       \
    auto* s = (loop_graph::State*)state;                                    \
    loop_graph::close(s);                                                   \
    delete s;                                                               \
  }

#endif  // __CUDACC__
