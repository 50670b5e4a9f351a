// Seq-locked shared-memory control bus for MPC <-> whole-body-control pipelining.
//
// Native counterpart of the reference's multiprocessing.shared_memory block with a
// seq-lock counter (ros2/run_controller.py:50-83, :305-362): the MPC process
// publishes a fixed layout of doubles (GRFs, footholds, joint targets, predicted
// state, step frequency, timing) at its own rate; the real-time torque loop reads
// the latest consistent snapshot without locks, allocations or syscalls on the hot
// path. Single-writer / many-reader.
//
// Layout: [ seq : uint64 | payload : N doubles ]. The writer increments seq to an
// odd value, writes the payload, then increments to the next even value (with
// release ordering); readers grab seq (acquire), copy, and retry if seq changed or
// was odd. Cache-line padding separates seq from the payload.
//
// Exposed as a tiny C API for ctypes. The port keeps its own copy of the JAX
// package's source (the same block layout, so that a writer of one package and a
// reader of the other share a bus); runtime/control_bus.py builds it with g++ at
// first use into quadruped_pympc_tamols_torch/_build/, named by its hash:
// g++ -O2 -shared -fPIC -o libcontrol_bus_<hash>.so control_bus.cpp -lrt -pthread

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr size_t kCacheLine = 64;

struct BusHeader {
  std::atomic<uint64_t> seq;
  uint32_t payload_doubles;
  uint32_t magic;
  char pad[kCacheLine - sizeof(std::atomic<uint64_t>) - 2 * sizeof(uint32_t)];
};
static_assert(sizeof(BusHeader) == kCacheLine, "header must be one cache line");

constexpr uint32_t kMagic = 0x51504d43;  // "QPMC"

struct Bus {
  BusHeader* hdr;
  double* payload;
  size_t size_bytes;
  int fd;
  bool owner;
  char name[256];
};

size_t bus_bytes(uint32_t n) { return sizeof(BusHeader) + n * sizeof(double); }

}  // namespace

extern "C" {

// Create (owner=1) or attach (owner=0) to a named bus with n_doubles payload slots.
// Returns an opaque handle or nullptr.
void* bus_open(const char* name, uint32_t n_doubles, int create) {
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  size_t bytes = bus_bytes(n_doubles);
  if (create && ftruncate(fd, (off_t)bytes) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    if (create) shm_unlink(name);
    return nullptr;
  }
  Bus* bus = new Bus;
  bus->hdr = reinterpret_cast<BusHeader*>(mem);
  bus->payload = reinterpret_cast<double*>(reinterpret_cast<char*>(mem) + sizeof(BusHeader));
  bus->size_bytes = bytes;
  bus->fd = fd;
  bus->owner = create != 0;
  std::strncpy(bus->name, name, sizeof(bus->name) - 1);
  bus->name[sizeof(bus->name) - 1] = 0;
  if (create) {
    bus->hdr->seq.store(0, std::memory_order_relaxed);
    bus->hdr->payload_doubles = n_doubles;
    bus->hdr->magic = kMagic;
    std::memset(bus->payload, 0, n_doubles * sizeof(double));
  } else if (bus->hdr->magic != kMagic || bus->hdr->payload_doubles != n_doubles) {
    munmap(mem, bytes);
    close(fd);
    delete bus;
    return nullptr;
  }
  return bus;
}

void bus_close(void* handle) {
  if (!handle) return;
  Bus* bus = static_cast<Bus*>(handle);
  munmap(bus->hdr, bus->size_bytes);
  close(bus->fd);
  if (bus->owner) shm_unlink(bus->name);
  delete bus;
}

// Publish a full payload snapshot (single writer). Wait-free.
void bus_write(void* handle, const double* data, uint32_t n) {
  Bus* bus = static_cast<Bus*>(handle);
  uint64_t s = bus->hdr->seq.load(std::memory_order_relaxed);
  bus->hdr->seq.store(s + 1, std::memory_order_release);  // odd: write in progress
  std::atomic_thread_fence(std::memory_order_release);
  std::memcpy(bus->payload, data, n * sizeof(double));
  std::atomic_thread_fence(std::memory_order_release);
  bus->hdr->seq.store(s + 2, std::memory_order_release);  // even: consistent
}

// Read the latest consistent snapshot. Returns the (even) sequence number observed,
// or 0 if nothing has ever been published. Lock-free; bounded retries then best
// effort (a torn read cannot persist because the writer is strictly faster than
// the retry loop's memcpy for this payload size).
uint64_t bus_read(void* handle, double* out, uint32_t n) {
  Bus* bus = static_cast<Bus*>(handle);
  for (int attempt = 0; attempt < 1000; ++attempt) {
    uint64_t s1 = bus->hdr->seq.load(std::memory_order_acquire);
    if (s1 == 0) return 0;
    if (s1 & 1) continue;  // write in progress
    std::atomic_thread_fence(std::memory_order_acquire);
    std::memcpy(out, bus->payload, n * sizeof(double));
    std::atomic_thread_fence(std::memory_order_acquire);
    uint64_t s2 = bus->hdr->seq.load(std::memory_order_acquire);
    if (s1 == s2) return s2;
  }
  return 0;
}

uint64_t bus_seq(void* handle) {
  return static_cast<Bus*>(handle)->hdr->seq.load(std::memory_order_acquire);
}

// Block (sleeping in 50us slices) until a snapshot newer than `last_seq` is
// published or timeout_us elapses. Returns the new sequence or 0 on timeout.
uint64_t bus_wait_new(void* handle, uint64_t last_seq, double* out, uint32_t n,
                      int64_t timeout_us) {
  Bus* bus = static_cast<Bus*>(handle);
  struct timespec ts = {0, 50 * 1000};
  int64_t waited = 0;
  while (waited <= timeout_us) {
    uint64_t s = bus->hdr->seq.load(std::memory_order_acquire);
    if (s > last_seq && !(s & 1)) {
      uint64_t got = bus_read(handle, out, n);
      if (got > last_seq) return got;
    }
    nanosleep(&ts, nullptr);
    waited += 50;
  }
  return 0;
}

}  // extern "C"
