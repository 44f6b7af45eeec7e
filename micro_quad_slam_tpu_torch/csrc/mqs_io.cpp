// Native host-side IO for micro_quad_slam_tpu: scanlog decoding and
// UART wire-stream parsing.
//
// The reference's ingest path is native C on the companion SBC (frame
// resync + checksum validation, uav_local_nav.c:1386-1427; scanlog
// writing, :1549-1581).  The rebuild's equivalent hot host path is
// decoding thousands of logged flights into struct-of-arrays buffers to
// feed the TPU; this library implements it in C++ (python fallback in
// micro_quad_slam_tpu/io/native.py, equality-tested against it).
//
// Layouts are byte-exact with the reference:
//   scanrec_t: 569 B packed, magic 'SCN2' (uav_local_nav.c:1522-1547)
//   SCAN frame: 518 B, 0xA5 | u32 t_ms | 256*u16le | xor8
//   CTRL frame: 7 B, 0xA6 | u8 cmd | u32 seq | xor8
// The CTRL parser steals 0xA6 bytes even mid-SCAN (the reference's
// observable resync quirk) — reproduced exactly.

#include <cstdint>
#include <cstring>

extern "C" {

struct ScanRecSoA {
  uint32_t* host_ms;
  uint32_t* scan_ms;
  float* x_m;
  float* y_m;
  float* yaw_deg;
  float* alt_m;
  float* roll_rad;
  float* pitch_rad;
  float* rf_m;
  float* of_rate_x;
  float* of_rate_y;
  uint8_t* of_q;
  uint8_t* state;
  uint8_t* kf_flags;
  uint32_t* sys_health;
  uint16_t* grid_mm;  // [n, 256]
};

static const uint32_t kMagic = 0x324E4353u;  // 'SCN2'
static const int kRecBytes = 569;
static const int kHdr = 7;  // "SCLOG2\n"

static inline uint32_t rd32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts only (x86/arm)
}

static inline float rdf(const uint8_t* p) {
  float v;
  std::memcpy(&v, p, 4);
  return v;
}

// Count well-formed records (after optional file header), skipping
// bad-magic records by record stride (the writer is record-aligned).
long long mqs_scanlog_count(const uint8_t* data, long long len) {
  if (len >= kHdr && std::memcmp(data, "SCLOG2\n", kHdr) == 0) {
    data += kHdr;
    len -= kHdr;
  }
  long long n = 0;
  for (long long off = 0; off + kRecBytes <= len; off += kRecBytes) {
    if (rd32(data + off) == kMagic) n++;
  }
  return n;
}

// Decode into caller-allocated SoA buffers sized by mqs_scanlog_count.
// Returns the number of records written.
long long mqs_scanlog_decode(const uint8_t* data, long long len,
                             ScanRecSoA* out) {
  if (len >= kHdr && std::memcmp(data, "SCLOG2\n", kHdr) == 0) {
    data += kHdr;
    len -= kHdr;
  }
  long long n = 0;
  for (long long off = 0; off + kRecBytes <= len; off += kRecBytes) {
    const uint8_t* r = data + off;
    if (rd32(r) != kMagic) continue;
    out->host_ms[n] = rd32(r + 4);
    out->scan_ms[n] = rd32(r + 8);
    out->x_m[n] = rdf(r + 12);
    out->y_m[n] = rdf(r + 16);
    out->yaw_deg[n] = rdf(r + 20);
    out->alt_m[n] = rdf(r + 24);
    out->roll_rad[n] = rdf(r + 28);
    out->pitch_rad[n] = rdf(r + 32);
    out->rf_m[n] = rdf(r + 36);
    out->of_rate_x[n] = rdf(r + 40);
    out->of_rate_y[n] = rdf(r + 44);
    out->of_q[n] = r[48];
    out->state[n] = r[49];
    out->kf_flags[n] = r[50];
    out->sys_health[n] = rd32(r + 53);
    std::memcpy(out->grid_mm + n * 256, r + 57, 512);
    n++;
  }
  return n;
}

// Byte-wise shared SCAN/CTRL stream parser (uav_local_nav.c:1386-1427
// semantics).  Outputs accepted scans (t_ms + 256 u16 cells each) and
// ctrl events (cmd, seq).  Caller sizes outputs generously:
// max_scans <= len/518 + 1, max_ctrls <= len/7 + 1.
// Returns number of scans; *n_ctrls_out receives ctrl count.
long long mqs_stream_decode(const uint8_t* data, long long len,
                            uint32_t* scan_t_ms, uint16_t* scan_grids,
                            long long max_scans, uint8_t* ctrl_cmd,
                            uint32_t* ctrl_seq, long long max_ctrls,
                            long long* n_ctrls_out) {
  uint8_t scan_buf[518];
  uint8_t ctrl_buf[7];
  int scan_pos = 0;
  int ctrl_pos = 0;
  long long ns = 0, nc = 0;

  for (long long i = 0; i < len; i++) {
    uint8_t b = data[i];

    // CTRL parser wins the byte when idle-on-0xA6 or mid-frame
    if (ctrl_pos == 0) {
      if (b == 0xA6) {
        ctrl_buf[ctrl_pos++] = b;
        continue;
      }
    } else {
      ctrl_buf[ctrl_pos++] = b;
      if (ctrl_pos == 7) {
        uint8_t c = 0;
        for (int k = 0; k < 6; k++) c ^= ctrl_buf[k];
        if (c == ctrl_buf[6] && nc < max_ctrls) {
          ctrl_cmd[nc] = ctrl_buf[1];
          ctrl_seq[nc] = rd32(ctrl_buf + 2);
          nc++;
        }
        ctrl_pos = 0;
      }
      continue;
    }

    // SCAN parser
    if (scan_pos == 0 && b != 0xA5) continue;
    scan_buf[scan_pos++] = b;
    if (scan_pos == 518) {
      uint8_t c = 0;
      for (int k = 0; k < 517; k++) c ^= scan_buf[k];
      if (c == scan_buf[517] && ns < max_scans) {
        scan_t_ms[ns] = rd32(scan_buf + 1);
        std::memcpy(scan_grids + ns * 256, scan_buf + 5, 512);
        ns++;
      }
      scan_pos = 0;
    }
  }
  *n_ctrls_out = nc;
  return ns;
}

}  // extern "C"
