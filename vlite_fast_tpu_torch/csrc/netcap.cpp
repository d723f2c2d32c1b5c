// Batched UDP capture helper: drain many VDIF-frame datagrams per syscall.
//
// The reference's hot capture loop pulls 20 packets per select() wake from
// a raw PF_PACKET socket (ref src/writer.c:611-614) to sustain 51,200
// frames/s/antenna.  A Python recvfrom loop pays a syscall + object churn
// per 5032-byte frame; recvmmsg amortizes that to one syscall per batch,
// landing frames contiguously so the Python side can parse headers and
// scatter payloads fully vectorized (runtime/capture.py feed_stream).
//
// C ABI for ctypes.  The port's copy of the JAX package's csrc/netcap.cpp,
// built by vlite_fast_tpu_torch/_build.py with g++ into a library of its own.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <linux/if_packet.h>
#include <vector>

extern "C" {

// Receive up to max_frames datagrams of exactly frame_bytes each into the
// contiguous buffer `buf` (size >= max_frames * frame_bytes).  Waits up to
// timeout_ms for the first datagram, then drains without blocking.
// Datagrams whose size differs from frame_bytes are dropped and counted in
// *anomalous (if non-null).  Returns the number of kept frames, or -1 on
// socket error.
int64_t udp_drain(int fd, void* buf, uint64_t frame_bytes,
                  uint64_t max_frames, int timeout_ms,
                  uint64_t* anomalous) {
  if (max_frames == 0) return 0;
  struct pollfd pfd = {fd, POLLIN, 0};
  int pr = poll(&pfd, 1, timeout_ms);
  if (pr <= 0) return pr < 0 ? -1 : 0;

  constexpr unsigned CHUNK = 64;
  static thread_local mmsghdr msgs[CHUNK];
  static thread_local iovec iovs[CHUNK];

  char* out = (char*)buf;
  uint64_t kept = 0, bad = 0;
  while (kept < max_frames) {
    unsigned want = max_frames - kept < CHUNK
                        ? (unsigned)(max_frames - kept) : CHUNK;
    for (unsigned i = 0; i < want; ++i) {
      iovs[i].iov_base = out + (kept + i) * frame_bytes;
      iovs[i].iov_len = frame_bytes;
      memset(&msgs[i].msg_hdr, 0, sizeof(msghdr));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
      msgs[i].msg_len = 0;
    }
    int n = recvmmsg(fd, msgs, want, MSG_DONTWAIT, nullptr);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
        break;                       // drained / interrupted: normal
      // fatal socket error (EBADF, ENOBUFS, ...): surface it — but not
      // at the cost of frames already drained; the NEXT call (kept==0)
      // returns -1 and the caller stops polling a dead socket.  Flush
      // the anomalous count first: datagrams dropped in earlier chunks
      // of this call must reach the writer-style abort accounting even
      // on the error path.
      if (kept == 0) {
        if (anomalous) *anomalous += bad;
        return -1;
      }
      break;
    }
    if (n == 0) break;
    // compact out wrong-sized datagrams (truncated reads report msg_len
    // == frame_bytes only for exact-size frames; oversize sets MSG_TRUNC)
    uint64_t good = kept;
    for (int i = 0; i < n; ++i) {
      bool ok = msgs[i].msg_len == frame_bytes &&
                !(msgs[i].msg_hdr.msg_flags & MSG_TRUNC);
      if (!ok) {
        ++bad;
        continue;
      }
      if (good != kept + (uint64_t)i)
        memmove(out + good * frame_bytes,
                out + (kept + i) * frame_bytes, frame_bytes);
      ++good;
    }
    bool drained = (unsigned)n < want;
    kept = good;
    if (drained) break;
  }
  if (anomalous) *anomalous += bad;
  return (int64_t)kept;
}

// AF_PACKET raw-socket drain: the reference's production capture path
// (ref src/utils.c:345-407 openRawSocket binds PF_PACKET to the fiber
// interface; src/writer.c:611-614 drains 20 packets per wake).  A raw
// socket sees EVERY packet on the interface, so unlike udp_drain this
// must (1) strip the ethernet/IPv4/UDP encapsulation to recover the VDIF
// frame and (2) filter to our stream: IPv4 + UDP + matching destination
// port.  Foreign traffic is skipped silently (it is not anomalous — a
// raw socket has no kernel-side port bind); packets that MATCH the port
// but carry a wrong-sized payload are counted in *anomalous, the same
// escalating-abort accounting the UDP path feeds.  PACKET_OUTGOING
// copies (loopback TX echoes) are skipped so a localhost soak counts
// each frame once.
//
// Same ABI shape as udp_drain; payloads land CONTIGUOUSLY in `buf`
// (headers stripped) so the Python side reuses the identical vectorized
// feed_stream fast path.
int64_t raw_drain(int fd, void* buf, uint64_t frame_bytes,
                  uint16_t udp_port, uint64_t max_frames, int timeout_ms,
                  uint64_t* anomalous) {
  if (max_frames == 0) return 0;
  struct pollfd pfd = {fd, POLLIN, 0};
  int pr = poll(&pfd, 1, timeout_ms);
  if (pr <= 0) return pr < 0 ? -1 : 0;

  constexpr unsigned CHUNK = 64;
  constexpr uint64_t ETH_HDR = 14, IP_HDR = 20, UDP_HDR = 8;
  const uint64_t wire_bytes = ETH_HDR + IP_HDR + UDP_HDR + frame_bytes;
  static thread_local mmsghdr msgs[CHUNK];
  static thread_local iovec iovs[CHUNK];
  static thread_local sockaddr_ll addrs[CHUNK];
  static thread_local std::vector<char> scratch;
  // +1 slack byte so an oversize packet shows msg_len > wire_bytes even
  // without MSG_TRUNC semantics differences across socket types
  const uint64_t slot = wire_bytes + 1;
  if (scratch.size() < CHUNK * slot) scratch.resize(CHUNK * slot);

  char* out = (char*)buf;
  uint64_t kept = 0, bad = 0;
  while (kept < max_frames) {
    unsigned want = max_frames - kept < CHUNK
                        ? (unsigned)(max_frames - kept) : CHUNK;
    for (unsigned i = 0; i < want; ++i) {
      iovs[i].iov_base = scratch.data() + i * slot;
      iovs[i].iov_len = slot;
      memset(&msgs[i].msg_hdr, 0, sizeof(msghdr));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
      msgs[i].msg_hdr.msg_name = &addrs[i];
      msgs[i].msg_hdr.msg_namelen = sizeof(sockaddr_ll);
      msgs[i].msg_len = 0;
    }
    int n = recvmmsg(fd, msgs, want, MSG_DONTWAIT, nullptr);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR)
        break;
      if (kept == 0) {
        if (anomalous) *anomalous += bad;
        return -1;
      }
      break;
    }
    if (n == 0) break;
    for (int i = 0; i < n; ++i) {
      if (addrs[i].sll_pkttype == PACKET_OUTGOING) continue;
      const unsigned char* p =
          (const unsigned char*)scratch.data() + (uint64_t)i * slot;
      uint64_t len = msgs[i].msg_len;
      // IPv4, no options, UDP (the VDIF encapsulation the VLA fiber
      // carries; an IHL > 5 packet is not our stream)
      if (len < ETH_HDR + IP_HDR + UDP_HDR) continue;
      if (p[12] != 0x08 || p[13] != 0x00) continue;      // ethertype IPv4
      if ((p[ETH_HDR] & 0xF0) != 0x40) continue;          // version 4
      if ((p[ETH_HDR] & 0x0F) != 5) continue;             // IHL 5
      if (p[ETH_HDR + 9] != 17) continue;                 // proto UDP
      uint16_t dport = (uint16_t)(p[ETH_HDR + IP_HDR + 2] << 8) |
                       p[ETH_HDR + IP_HDR + 3];
      if (udp_port != 0 && dport != udp_port) continue;
      if (len != wire_bytes ||
          (msgs[i].msg_hdr.msg_flags & MSG_TRUNC)) {
        ++bad;                       // our stream, wrong frame size
        continue;
      }
      memcpy(out + kept * frame_bytes, p + ETH_HDR + IP_HDR + UDP_HDR,
             frame_bytes);
      if (++kept >= max_frames) break;
    }
    if ((unsigned)n < want) break;   // drained
  }
  if (anomalous) *anomalous += bad;
  return (int64_t)kept;
}

// Batched UDP send: blast `n` frames of frame_bytes each from the
// contiguous buffer over a CONNECTED datagram socket via sendmmsg.
// Returns frames sent (may be < n on EAGAIN), -1 on error.  Test-side
// counterpart of udp_drain: a Python sendto loop tops out well below the
// 51,200 frames/s wire rate, which would bound any loopback soak.
int64_t udp_blast(int fd, const void* buf, uint64_t frame_bytes,
                  uint64_t n) {
  constexpr unsigned CHUNK = 64;
  static thread_local mmsghdr msgs[CHUNK];
  static thread_local iovec iovs[CHUNK];
  const char* p = (const char*)buf;
  uint64_t sent = 0;
  while (sent < n) {
    unsigned want = n - sent < CHUNK ? (unsigned)(n - sent) : CHUNK;
    for (unsigned i = 0; i < want; ++i) {
      iovs[i].iov_base = (void*)(p + (sent + i) * frame_bytes);
      iovs[i].iov_len = frame_bytes;
      memset(&msgs[i].msg_hdr, 0, sizeof(msghdr));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    int k = sendmmsg(fd, msgs, want, 0);
    if (k < 0) return sent ? (int64_t)sent : -1;
    sent += k;
    if ((unsigned)k < want) break;  // backpressure
  }
  return (int64_t)sent;
}

}  // extern "C"
