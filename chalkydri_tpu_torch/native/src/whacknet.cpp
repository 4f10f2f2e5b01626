// whacknet native fast path: UDP pose uplink + gyro downlink.
//
// C++ rebuild of the reference's whacknet crate threading model
// (crates/whacknet/src/lib.rs:100-185): a sender thread
// draining a queue (so publish() never blocks the vision hot path) and a
// gyro listener thread keeping the latest heading. Exposed as a C API for
// ctypes (a plain C interface, no Python headers); holds no Python state and never
// touches the GIL.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr int kMaxPacket = 64;  // VisionMeasurement size (whacknet lib.rs:92-95)

struct Channel {
  int send_fd = -1;
  int gyro_fd = -1;
  sockaddr_in remote{};
  std::thread sender;
  std::thread gyro;
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::vector<unsigned char>> queue;
  std::atomic<bool> running{false};
  std::atomic<double> gyro_value{0.0};
  std::atomic<bool> gyro_seen{true};  // starts Some(0.0) like the reference
};

constexpr int kMaxChannels = 16;
Channel* g_channels[kMaxChannels] = {nullptr};
std::mutex g_channels_mu;

void sender_loop(Channel* ch) {
  while (true) {
    std::vector<unsigned char> pkt;
    {
      std::unique_lock<std::mutex> lk(ch->mu);
      ch->cv.wait(lk, [ch] { return !ch->queue.empty() || !ch->running; });
      if (!ch->running && ch->queue.empty()) return;
      pkt = std::move(ch->queue.front());
      ch->queue.pop_front();
    }
    (void)sendto(ch->send_fd, pkt.data(), pkt.size(), 0,
                 reinterpret_cast<sockaddr*>(&ch->remote), sizeof(ch->remote));
  }
}

void gyro_loop(Channel* ch) {
  unsigned char buf[8];
  while (ch->running) {
    ssize_t n = recv(ch->gyro_fd, buf, sizeof(buf), 0);
    if (n == 8) {
      double v;
      std::memcpy(&v, buf, 8);  // wire format: little-endian f64 (lib.rs:123)
      ch->gyro_value.store(v, std::memory_order_relaxed);
      ch->gyro_seen.store(true, std::memory_order_relaxed);
    } else if (n < 0) {
      // timeout (SO_RCVTIMEO) or shutdown; loop re-checks running.
      continue;
    }
  }
}

}  // namespace

extern "C" {

int whacknet_start(const char* remote_addr, int remote_port, int gyro_port) {
  auto* ch = new Channel();
  ch->send_fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (ch->send_fd < 0) {
    delete ch;
    return -1;
  }
  ch->remote.sin_family = AF_INET;
  ch->remote.sin_port = htons(static_cast<uint16_t>(remote_port));
  if (inet_pton(AF_INET, remote_addr, &ch->remote.sin_addr) != 1) {
    close(ch->send_fd);
    delete ch;
    return -1;
  }

  ch->gyro_fd = socket(AF_INET, SOCK_DGRAM, 0);
  int one = 1;
  setsockopt(ch->gyro_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  timeval tv{0, 200000};  // 200 ms poll so shutdown is prompt
  setsockopt(ch->gyro_fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in local{};
  local.sin_family = AF_INET;
  local.sin_addr.s_addr = INADDR_ANY;
  local.sin_port = htons(static_cast<uint16_t>(gyro_port));
  if (bind(ch->gyro_fd, reinterpret_cast<sockaddr*>(&local), sizeof(local)) <
      0) {
    close(ch->send_fd);
    close(ch->gyro_fd);
    delete ch;
    return -1;
  }

  ch->running = true;
  ch->sender = std::thread(sender_loop, ch);
  ch->gyro = std::thread(gyro_loop, ch);

  std::lock_guard<std::mutex> lk(g_channels_mu);
  for (int i = 0; i < kMaxChannels; ++i) {
    if (g_channels[i] == nullptr) {
      g_channels[i] = ch;
      return i;
    }
  }
  // Table full.
  ch->running = false;
  ch->cv.notify_all();
  ch->sender.join();
  ch->gyro.join();
  close(ch->send_fd);
  close(ch->gyro_fd);
  delete ch;
  return -1;
}

int whacknet_send(int handle, const unsigned char* data, int len) {
  if (handle < 0 || handle >= kMaxChannels) return -1;
  Channel* ch = g_channels[handle];
  if (ch == nullptr || len <= 0 || len > kMaxPacket) return -1;
  {
    std::lock_guard<std::mutex> lk(ch->mu);
    // Bounded queue: drop-oldest under backpressure, like the reference's
    // depth-1 appsink policy (SURVEY.md section 5.3).
    if (ch->queue.size() >= 64) ch->queue.pop_front();
    ch->queue.emplace_back(data, data + len);
  }
  ch->cv.notify_one();
  return 0;
}

int whacknet_gyro(int handle, double* out) {
  if (handle < 0 || handle >= kMaxChannels) return 0;
  Channel* ch = g_channels[handle];
  if (ch == nullptr || !ch->gyro_seen.load(std::memory_order_relaxed)) return 0;
  *out = ch->gyro_value.load(std::memory_order_relaxed);
  return 1;
}

void whacknet_stop(int handle) {
  if (handle < 0 || handle >= kMaxChannels) return;
  Channel* ch;
  {
    std::lock_guard<std::mutex> lk(g_channels_mu);
    ch = g_channels[handle];
    g_channels[handle] = nullptr;
  }
  if (ch == nullptr) return;
  ch->running = false;
  ch->cv.notify_all();
  ch->sender.join();
  ch->gyro.join();
  close(ch->send_fd);
  close(ch->gyro_fd);
  delete ch;
}

}  // extern "C"
