// Native host planner of tpu_qsim_torch: gate-fusion grouping and
// grid-sweep partitioning.
//
// The same algorithms as the port's Python planners (tpu_qsim_torch/
// fusion.py::_plan_groups_python and the frontier loop of
// tpu_qsim_torch/kernels/gridsweeps.py::_frontier_sweeps_python), which stay
// as the plain versions the tests hold this library against: results are
// bit-identical (tests/test_torch_native.py). Planning is host work on the
// gate list; the plans it makes run on the CUDA kernels.
//
// A plain C ABI, loaded with ctypes (tpu_qsim_torch/native/__init__.py),
// which builds this file with g++ at first use.

#include <cstdint>
#include <set>
#include <vector>

namespace {

struct OpenGroup {
    uint64_t qubit_mask = 0;
    int size = 0;
};

inline int popcount64(uint64_t x) { return __builtin_popcountll(x); }

}  // namespace

extern "C" {

// Assign each gate a fusion-group id.
//
//   num_qubits      total qubits in the circuit
//   num_gates       number of gates
//   gate_qubits     flattened qubit indices
//   gate_offsets    size num_gates+1; gate g's qubits are
//                   gate_qubits[gate_offsets[g] .. gate_offsets[g+1])
//   max_fused       max qubits per fused group
//   group_ids_out   size num_gates; receives the group id per gate
//
// Returns the number of groups (or -1 on invalid input).
//
// Invariant (same as the Python planner): a gate joins the *latest* group
// touching any of its qubits when the union fits, else the first later group
// with room, else a new group. Group ids are emission-ordered.
int qsim_plan_groups(int num_qubits, int num_gates,
                     const int32_t* gate_qubits, const int32_t* gate_offsets,
                     int max_fused, int32_t* group_ids_out) {
    if (num_qubits < 1 || num_qubits > 63 || num_gates < 0 || max_fused < 1)
        return -1;

    std::vector<OpenGroup> groups;
    groups.reserve(num_gates);
    std::vector<int> last_touch(num_qubits, -1);

    for (int g = 0; g < num_gates; ++g) {
        uint64_t mask = 0;
        int dep = -1;
        for (int i = gate_offsets[g]; i < gate_offsets[g + 1]; ++i) {
            int q = gate_qubits[i];
            if (q < 0 || q >= num_qubits) return -1;
            mask |= (1ULL << q);
            if (last_touch[q] > dep) dep = last_touch[q];
        }

        int placed = -1;
        if (dep >= 0 &&
            popcount64(groups[dep].qubit_mask | mask) <= max_fused) {
            placed = dep;
        } else {
            int start = dep + 1 > 0 ? dep + 1 : 0;
            for (int c = start; c < static_cast<int>(groups.size()); ++c) {
                if (popcount64(groups[c].qubit_mask | mask) <= max_fused) {
                    placed = c;
                    break;
                }
            }
            if (placed < 0) {
                groups.push_back(OpenGroup{});
                placed = static_cast<int>(groups.size()) - 1;
            }
        }
        groups[placed].qubit_mask |= mask;
        groups[placed].size += 1;
        group_ids_out[g] = placed;
        for (int i = gate_offsets[g]; i < gate_offsets[g + 1]; ++i) {
            int q = gate_qubits[i];
            if (placed > last_touch[q]) last_touch[q] = placed;
        }
    }
    return static_cast<int>(groups.size());
}

// Grid-sweep partitioning: commutation-DAG frontier scheduling with greedy
// active-bit packing, the frontier loop of
// tpu_qsim_torch/kernels/gridsweeps.py::plan_grid_sweeps.
//
// Inputs are matrix-free: Python passes per-qubit commutation classes
// (tpu_qsim_torch/commute.py: DIAG=0 / FLIP=1 / OTHER=2) and the per-gate
// mask of moving qubits at or above the block boundary. Two gates commute
// iff their qubit sets are disjoint, or every shared qubit carries the same
// non-OTHER class on both sides (commute.py::gates_commute).
//
//   num_gates       number of gates (after SWAP decomposition and the
//                   1-qubit chain fold, validated by the caller)
//   gate_qubits     flattened qubit indices
//   gate_offsets    size num_gates+1 (same layout as qsim_plan_groups)
//   gate_classes    per-qubit class, aligned with gate_qubits
//   moving_masks    per-gate bitmask of moving qubits >= blk_bits
//   a_max           max active (high, moving) bits a sweep may stack
//   max_gates       max gates per sweep
//   sweep_ids_out   size num_gates; sweep id per gate
//   emit_order_out  size num_gates; gate indices in emission order (a sweep's
//                   gate order is emission order, not index order)
//
// Returns the number of sweeps (or -1 on invalid input / an unplaceable
// gate, i.e. popcount(moving_mask) > a_max, which Python rejects first).
int qsim_plan_grid_sweeps(int num_gates, const int32_t* gate_qubits,
                          const int32_t* gate_offsets,
                          const int8_t* gate_classes,
                          const uint64_t* moving_masks, int a_max,
                          int max_gates, int32_t* sweep_ids_out,
                          int32_t* emit_order_out) {
    if (num_gates < 0 || a_max < 0 || max_gates < 1) return -1;
    if (num_gates == 0) return 0;

    std::vector<uint64_t> qmask(num_gates, 0);
    for (int g = 0; g < num_gates; ++g) {
        for (int i = gate_offsets[g]; i < gate_offsets[g + 1]; ++i) {
            int q = gate_qubits[i];
            if (q < 0 || q > 63) return -1;
            qmask[g] |= (1ULL << q);
        }
        if (popcount64(moving_masks[g]) > a_max) return -1;
    }

    // class of qubit q within gate g, or -1 if g does not touch q
    auto class_of = [&](int g, int q) -> int {
        for (int i = gate_offsets[g]; i < gate_offsets[g + 1]; ++i)
            if (gate_qubits[i] == q) return gate_classes[i];
        return -1;
    };
    auto commute = [&](int i, int j) -> bool {
        uint64_t shared = qmask[i] & qmask[j];
        while (shared) {
            int q = __builtin_ctzll(shared);
            shared &= shared - 1;
            int ci = class_of(i, q), cj = class_of(j, q);
            if (ci != cj || ci == 2 /* OTHER */) return false;
        }
        return true;
    };

    // dependency DAG (commute.py::dependency_edges keeps transitively
    // redundant edges; so do we: identical ready-set evolution)
    std::vector<int> missing(num_gates, 0);
    std::vector<std::vector<int>> succs(num_gates);
    for (int j = 0; j < num_gates; ++j)
        for (int i = 0; i < j; ++i)
            if (!commute(i, j)) {
                ++missing[j];
                succs[i].push_back(j);
            }

    std::set<int> ready;  // ordered: ascending-index scan = program order
    for (int g = 0; g < num_gates; ++g)
        if (missing[g] == 0) ready.insert(g);

    int emitted = 0;
    int sweep = 0;
    uint64_t active = 0;
    int count = 0;
    while (!ready.empty()) {
        bool progressed = true;
        while (progressed) {
            progressed = false;
            for (int i : ready) {
                if (count < max_gates &&
                    popcount64(active | moving_masks[i]) <= a_max) {
                    ready.erase(i);
                    for (int j : succs[i])
                        if (--missing[j] == 0) ready.insert(j);
                    sweep_ids_out[i] = sweep;
                    emit_order_out[emitted++] = i;
                    active |= moving_masks[i];
                    ++count;
                    progressed = true;
                    break;  // restart the ascending scan, like the Python
                }
            }
        }
        if (ready.empty()) break;
        ++sweep;  // close the sweep; a fresh one always absorbs >= 1 gate
        active = 0;
        count = 0;
    }
    return emitted == num_gates ? sweep + 1 : -1;
}

}  // extern "C"
