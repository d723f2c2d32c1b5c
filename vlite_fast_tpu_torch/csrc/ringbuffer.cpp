// Shared-memory ring buffer: the intra-node data plane.
//
// TPU-native replacement for PSRDADA's ipcbuf/ipcio rings (the reference's
// entire intra-node data plane, SURVEY.md section 2a #19): fixed-count,
// fixed-size buffers in POSIX shared memory, single writer / single reader
// plus passive "viewers" (the dumper pattern, ref src/dumper.c:162-166,
// which walks ring internals directly to map trigger times to buffers).
//
// Layout in the shm segment:
//   [RBHeader][slot metadata x nbufs][data: nbufs x bufsz]
//
// Concurrency: head/tail are C++11 atomics on process-shared memory;
// acquire/commit protocol, no locks.  The writer overruns nothing: a write
// acquires only when head - tail < nbufs (like ipcbuf full checks,
// ref src/process_baseband.cu:306-320).
//
// Exposed as a C ABI for ctypes (runtime/ring.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t MAGIC = 0x56464153545f5242ull;  // "VFAST_RB"

struct SlotMeta {
  uint64_t nbytes;     // valid bytes in the slot
  uint64_t seq;        // monotonically increasing slot sequence number
  double   timestamp;  // producer-assigned time tag (e.g. unix seconds)
  uint64_t flags;      // user flags (e.g. start-of-observation)
};

struct RBHeader {
  uint64_t magic;
  uint64_t bufsz;
  uint64_t nbufs;
  std::atomic<uint64_t> head;      // next slot to write (count, not index)
  std::atomic<uint64_t> tail;      // next slot to read
  std::atomic<uint64_t> dropped;   // writer-side drops (ring full)
  char obs_header[4096];           // current observation ASCII header
  std::atomic<uint64_t> obs_seq;   // bumped when obs_header changes
};

struct Ring {
  RBHeader* hdr;
  SlotMeta* meta;
  char* data;
  size_t map_len;
  int owner;
  char name[256];
};

size_t total_len(uint64_t bufsz, uint64_t nbufs) {
  return sizeof(RBHeader) + sizeof(SlotMeta) * nbufs + bufsz * nbufs;
}

Ring* map_ring(const char* name, uint64_t bufsz, uint64_t nbufs, int create) {
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0660);
  if (fd < 0) return nullptr;
  size_t len;
  if (create) {
    len = total_len(bufsz, nbufs);
    if (ftruncate(fd, (off_t)len) != 0) { close(fd); return nullptr; }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    len = (size_t)st.st_size;
  }
  void* p = mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return nullptr;
  Ring* r = new Ring();
  r->hdr = (RBHeader*)p;
  r->map_len = len;
  r->owner = create;
  snprintf(r->name, sizeof(r->name), "%s", name);
  if (create) {
    memset(p, 0, sizeof(RBHeader) + sizeof(SlotMeta) * nbufs);
    r->hdr->magic = MAGIC;
    r->hdr->bufsz = bufsz;
    r->hdr->nbufs = nbufs;
    r->hdr->head.store(0);
    r->hdr->tail.store(0);
    r->hdr->dropped.store(0);
    r->hdr->obs_seq.store(0);
  } else if (r->hdr->magic != MAGIC) {
    munmap(p, len);
    delete r;
    return nullptr;
  }
  r->meta = (SlotMeta*)((char*)p + sizeof(RBHeader));
  r->data = (char*)p + sizeof(RBHeader) + sizeof(SlotMeta) * r->hdr->nbufs;
  return r;
}

}  // namespace

extern "C" {

void* rb_create(const char* name, uint64_t bufsz, uint64_t nbufs) {
  shm_unlink(name);  // fresh ring (like dada_db recreating a wedged ring)
  return map_ring(name, bufsz, nbufs, 1);
}

void* rb_attach(const char* name) { return map_ring(name, 0, 0, 0); }

void rb_close(void* vr, int unlink) {
  Ring* r = (Ring*)vr;
  if (!r) return;
  if (unlink) shm_unlink(r->name);
  munmap((void*)r->hdr, r->map_len);
  delete r;
}

uint64_t rb_bufsz(void* vr) { return ((Ring*)vr)->hdr->bufsz; }
uint64_t rb_nbufs(void* vr) { return ((Ring*)vr)->hdr->nbufs; }
uint64_t rb_nfull(void* vr) {
  Ring* r = (Ring*)vr;
  return r->hdr->head.load() - r->hdr->tail.load();
}
uint64_t rb_dropped(void* vr) { return ((Ring*)vr)->hdr->dropped.load(); }

// Writer: copy a full slot in.  Returns slot seq, or -1 if the ring is full
// (caller decides whether to drop or abort; the reference aborts the
// observation, writer.c:719-727).  With overwrite != 0 the ring acts as a
// rolling history (the voltage-dump buffer use case): a full ring advances
// tail, discarding the oldest second.
static int64_t rb_write_impl(void* vr, const void* buf, uint64_t nbytes,
                             double timestamp, uint64_t flags,
                             int overwrite) {
  Ring* r = (Ring*)vr;
  RBHeader* h = r->hdr;
  if (nbytes > h->bufsz) return -2;
  uint64_t head = h->head.load(std::memory_order_relaxed);
  for (;;) {
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    if (head - tail < h->nbufs) break;     // space available
    if (!overwrite) {
      h->dropped.fetch_add(1);
      return -1;
    }
    // CAS, not fetch_add: a concurrent rb_read may advance tail between
    // our fullness check and here; an unconditional increment would then
    // skip an unread slot silently.  On a lost race the ring has space —
    // loop re-checks.
    if (h->tail.compare_exchange_strong(tail, tail + 1,
                                        std::memory_order_acq_rel))
      break;
  }
  uint64_t idx = head % h->nbufs;
  memcpy(r->data + idx * h->bufsz, buf, nbytes);
  SlotMeta* m = &r->meta[idx];
  m->nbytes = nbytes;
  // release-store so rb_peek_seq's acquire re-check pairs with it (and
  // the compiler cannot fold the viewer's two seq loads into one)
  __atomic_store_n(&m->seq, head, __ATOMIC_RELEASE);
  m->timestamp = timestamp;
  m->flags = flags;
  h->head.store(head + 1, std::memory_order_release);
  return (int64_t)head;
}

int64_t rb_write(void* vr, const void* buf, uint64_t nbytes,
                 double timestamp, uint64_t flags) {
  return rb_write_impl(vr, buf, nbytes, timestamp, flags, 0);
}

int64_t rb_write_overwrite(void* vr, const void* buf, uint64_t nbytes,
                           double timestamp, uint64_t flags) {
  return rb_write_impl(vr, buf, nbytes, timestamp, flags, 1);
}

// Reader: copy the next slot out.  Returns nbytes, or -1 if empty.
// Tail advances with compare_exchange so pairing a consuming reader with
// an overwrite-mode writer (which also advances tail, rb_write_impl above)
// can never store a stale tail value and move the cursor backwards; on a
// lost race the slot was overwritten anyway, so retry on the new tail.
int64_t rb_read(void* vr, void* buf, uint64_t maxbytes,
                double* timestamp, uint64_t* flags) {
  Ring* r = (Ring*)vr;
  RBHeader* h = r->hdr;
  for (;;) {
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    if (tail >= h->head.load(std::memory_order_acquire)) return -1;
    uint64_t idx = tail % h->nbufs;
    SlotMeta* m = &r->meta[idx];
    uint64_t n = m->nbytes < maxbytes ? m->nbytes : maxbytes;
    memcpy(buf, r->data + idx * h->bufsz, n);
    if (timestamp) *timestamp = m->timestamp;
    if (flags) *flags = m->flags;
    if (h->tail.compare_exchange_strong(tail, tail + 1,
                                        std::memory_order_acq_rel))
      return (int64_t)n;
    // an overwrite writer reclaimed this slot mid-read; re-read at the
    // advanced tail (the data just copied may be torn — discard it)
  }
}

// Viewer (dumper semantics): copy ANY still-resident slot by sequence
// number without consuming it.  Returns nbytes or -1 if the slot has been
// overwritten / doesn't exist yet.
int64_t rb_peek_seq(void* vr, uint64_t seq, void* buf, uint64_t maxbytes,
                    double* timestamp) {
  Ring* r = (Ring*)vr;
  RBHeader* h = r->hdr;
  uint64_t head = h->head.load(std::memory_order_acquire);
  if (seq >= head || head - seq > h->nbufs) return -1;
  uint64_t idx = seq % h->nbufs;
  SlotMeta* m = &r->meta[idx];
  if (__atomic_load_n(&m->seq, __ATOMIC_ACQUIRE) != seq) return -1;
  uint64_t n = m->nbytes < maxbytes ? m->nbytes : maxbytes;
  memcpy(buf, r->data + idx * h->bufsz, n);
  if (timestamp) *timestamp = m->timestamp;
  // re-check the slot wasn't recycled mid-copy (racy-by-design viewer,
  // tolerated exactly as in the reference dumper: seconds-deep buffers,
  // dumps target the past).  ATOMIC load: a plain re-read of the same
  // non-volatile lvalue may legally be folded into the first load,
  // silencing the torn-copy guard.
  if (__atomic_load_n(&m->seq, __ATOMIC_ACQUIRE) != seq) return -1;
  return (int64_t)n;
}

// Range of slot sequence numbers currently resident: [out_lo, out_hi)
void rb_resident(void* vr, uint64_t* out_lo, uint64_t* out_hi) {
  Ring* r = (Ring*)vr;
  uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  uint64_t nb = r->hdr->nbufs;
  *out_hi = head;
  *out_lo = head > nb ? head - nb : 0;
}

double rb_slot_timestamp(void* vr, uint64_t seq) {
  Ring* r = (Ring*)vr;
  uint64_t idx = seq % r->hdr->nbufs;
  SlotMeta* m = &r->meta[idx];
  if (m->seq != seq) return -1.0;
  return m->timestamp;
}

// Observation header block (psrdada header-block equivalent)
void rb_set_obs_header(void* vr, const char* hdr) {
  Ring* r = (Ring*)vr;
  snprintf(r->hdr->obs_header, sizeof(r->hdr->obs_header), "%s", hdr);
  r->hdr->obs_seq.fetch_add(1);
}

uint64_t rb_get_obs_header(void* vr, char* out, uint64_t maxlen) {
  Ring* r = (Ring*)vr;
  snprintf(out, maxlen, "%s", r->hdr->obs_header);
  return r->hdr->obs_seq.load();
}

}  // extern "C"
