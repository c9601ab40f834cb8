// The host harness's driver: runs the port's extern "C" launchers, built
// for the CPU, on buffers read from a file, and writes the buffers back.
//
//   qsim_host_run IN OUT
//
// IN holds "QSIMHOST", the buffers (u32 count; each a u64 byte count and
// its bytes) and the calls (u32 count; each its name as a u32 length and
// bytes, then u32 arguments, each a u8 kind: 0 an i64 scalar, 1 a buffer as
// its u32 index, 2 a null pointer). OUT holds
// "QSIMHOST", each call's int result (u32 count, i32 each) and the buffers
// as IN holds them. Each buffer is a heap allocation of its exact size, so
// AddressSanitizer reports an access past it. A sanitizer report, a trap or
// a deadlock ends the process with a message on standard error and no OUT.

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <map>
#include <string>
#include <type_traits>
#include <utility>
#include <vector>

extern "C" {
int grid_sweep_launch(float*, long long, const int*, const float*, int, long long, int, void*);
int sweep_prepare(int, int, int, int*);
int sweep_launch(int, float*, long long, const int*, const float*, int, unsigned*, int, int, int,
                 int, int, void*);
int segment_prepare(int, int, int*);
int segment_launch(float*, float*, long long, const int*, const float*, unsigned*, int, int, int,
                   int, int, void*);
int dense_pass_launch(const float*, float*, long long, const float*, int, unsigned, unsigned,
                      unsigned, int, void*);
int rotation_chain_launch(float*, long long, const float*, int, int, unsigned, void*);
int host_fault_launch(int, float*, long long, int, unsigned*);
}

namespace {

struct Arg {
  int kind;
  long long scalar;
  char* ptr;
};

[[noreturn]] void die(const char* what) {
  fprintf(stderr, "qsim_host_run: %s\n", what);
  exit(2);
}

struct Reader {
  FILE* f;
  template <class T>
  T get() {
    T v;
    if (fread(&v, sizeof(T), 1, f) != 1) die("truncated input");
    return v;
  }
  void bytes(void* p, size_t n) {
    if (n && fread(p, 1, n, f) != n) die("truncated input");
  }
};

template <class T>
T convert(const Arg& a) {
  if constexpr (std::is_pointer_v<T>) {
    if (a.kind == 0) die("a scalar where the launcher takes a pointer");
    return reinterpret_cast<T>(a.ptr);
  } else {
    if (a.kind != 0) die("a pointer where the launcher takes a scalar");
    return static_cast<T>(a.scalar);
  }
}

using Caller = int (*)(const std::vector<Arg>&);

template <auto Fn, class... P, size_t... I>
int call(const std::vector<Arg>& args, int (*)(P...), std::index_sequence<I...>) {
  if (args.size() != sizeof...(P)) die("wrong number of arguments");
  return Fn(convert<P>(args[I])...);
}

template <auto Fn>
int caller(const std::vector<Arg>& args) {
  return []<class... P>(const std::vector<Arg>& a, int (*f)(P...)) {
    return call<Fn>(a, f, std::index_sequence_for<P...>{});
  }(args, Fn);
}

const std::map<std::string, Caller> LAUNCHERS = {
    {"grid_sweep_launch", caller<grid_sweep_launch>},
    {"sweep_prepare", caller<sweep_prepare>},
    {"sweep_launch", caller<sweep_launch>},
    {"segment_prepare", caller<segment_prepare>},
    {"segment_launch", caller<segment_launch>},
    {"dense_pass_launch", caller<dense_pass_launch>},
    {"rotation_chain_launch", caller<rotation_chain_launch>},
    {"host_fault_launch", caller<host_fault_launch>},
};

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) die("usage: qsim_host_run IN OUT");
  FILE* in = fopen(argv[1], "rb");
  if (!in) die("cannot open the input");
  Reader r{in};
  char magic[8];
  r.bytes(magic, 8);
  if (memcmp(magic, "QSIMHOST", 8)) die("not an input file");
  std::vector<std::pair<char*, size_t>> buffers(r.get<uint32_t>());
  for (auto& [p, n] : buffers) {
    n = r.get<uint64_t>();
    void* mem = nullptr;
    if (posix_memalign(&mem, 64, n ? n : 1)) die("out of memory");
    p = static_cast<char*>(mem);
    r.bytes(p, n);
  }
  std::vector<int> results;
  for (uint32_t c = r.get<uint32_t>(); c; --c) {
    std::string name(r.get<uint32_t>(), '\0');
    r.bytes(name.data(), name.size());
    std::vector<Arg> args(r.get<uint32_t>());
    for (Arg& a : args) {
      a.kind = r.get<uint8_t>();
      if (a.kind == 0) {
        a.scalar = r.get<int64_t>();
      } else if (a.kind == 1) {
        const uint32_t i = r.get<uint32_t>();
        if (i >= buffers.size()) die("a bad buffer reference");
        a.ptr = buffers[i].first;
      } else if (a.kind == 2) {
        a.ptr = nullptr;
      } else {
        die("a bad argument kind");
      }
    }
    auto it = LAUNCHERS.find(name);
    if (it == LAUNCHERS.end()) die("an unknown launcher");
    results.push_back(it->second(args));
  }
  fclose(in);
  FILE* out = fopen(argv[2], "wb");
  if (!out) die("cannot open the output");
  const uint32_t nres = results.size(), nbuf = buffers.size();
  fwrite("QSIMHOST", 1, 8, out);
  fwrite(&nres, 4, 1, out);
  fwrite(results.data(), 4, nres, out);
  fwrite(&nbuf, 4, 1, out);
  for (auto& [p, n] : buffers) {
    const uint64_t n64 = n;
    fwrite(&n64, 8, 1, out);
    fwrite(p, 1, n, out);
    free(p);
  }
  if (fclose(out)) die("cannot write the output");
  return 0;
}
