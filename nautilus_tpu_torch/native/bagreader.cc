// Fast ROS bag (v2.0) scanner + message decoder for nautilus_tpu_torch
// ingest (the port's own copy of nautilus_tpu/native/bagreader.cc).
//
// Native replacement for the IO hot loop of bag replay (reference
// src/main.cc:46-129 uses rosbag::View; the Python reader is
// nautilus_tpu_torch/ingest/rosbag.py).  Parses the public bag container format
// sequentially — length-prefixed records, chunks (none/bz2 compression),
// connection + message-data records — and decodes the three message types
// nautilus consumes (sensor_msgs/LaserScan, nav_msgs/Odometry,
// CobotOdometryMsg) into flat arrays exposed over a C ABI for ctypes.
//
// Build: see nautilus_tpu_torch/ingest/native.py (g++ at first use into
// build/nautilus_tpu_torch/; links the system libbz2 shared object
// directly, declaring the one symbol it needs, since the -dev header may
// not be installed).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" int BZ2_bzBuffToBuffDecompress(char* dest, unsigned* destLen,
                                          char* source, unsigned sourceLen,
                                          int small, int verbosity);
#ifndef NTBAG_NO_LZ4
extern "C" int LZ4_decompress_safe(const char* src, char* dst,
                                   int compressedSize, int dstCapacity);
extern "C" int LZ4_decompress_safe_usingDict(const char* src, char* dst,
                                             int compressedSize,
                                             int dstCapacity,
                                             const char* dictStart,
                                             int dictSize);
#endif

namespace {

#ifndef NTBAG_NO_LZ4
// Decode one LZ4 frame (rosbag lz4 chunks = roslz4's "lz4s" stream, which
// is the standard LZ4 Frame Format).  Checksums are skipped, not verified.
// Returns true on success.
bool lz4_frame_decompress(const uint8_t* src, size_t n,
                          std::vector<char>* out) {
  if (n < 7) return false;
  uint32_t magic;
  std::memcpy(&magic, src, 4);
  if (magic != 0x184D2204u) return false;
  uint8_t flg = src[4], bd = src[5];
  if ((flg >> 6) != 1) return false;
  bool block_indep = flg & 0x20;
  bool block_checksum = flg & 0x10;
  bool content_size = flg & 0x08;
  int bmax_code = (bd >> 4) & 0x7;
  if (bmax_code < 4 || bmax_code > 7) return false;
  size_t block_max = 1u << (2 * bmax_code + 8);  // 4->64KB ... 7->4MB
  size_t pos = 6 + (content_size ? 8 : 0) + 1;   // + header checksum byte
  std::vector<char> block_out(block_max);
  while (true) {
    if (pos + 4 > n) return false;
    uint32_t size;
    std::memcpy(&size, src + pos, 4);
    pos += 4;
    if (size == 0) break;
    bool stored = size & 0x80000000u;
    size &= 0x7FFFFFFFu;
    if (pos + size > n) return false;
    if (stored) {
      out->insert(out->end(), src + pos, src + pos + size);
    } else {
      int rc;
      if (block_indep) {
        rc = LZ4_decompress_safe(
            reinterpret_cast<const char*>(src + pos), block_out.data(),
            static_cast<int>(size), static_cast<int>(block_max));
      } else {
        size_t dict = out->size() < 65536 ? out->size() : 65536;
        rc = LZ4_decompress_safe_usingDict(
            reinterpret_cast<const char*>(src + pos), block_out.data(),
            static_cast<int>(size), static_cast<int>(block_max),
            out->data() + out->size() - dict, static_cast<int>(dict));
      }
      if (rc < 0) return false;
      out->insert(out->end(), block_out.data(), block_out.data() + rc);
    }
    pos += size;
    if (block_checksum) pos += 4;
  }
  return true;
}
#endif

struct Scan {
  double stamp;
  double angle_min, angle_max, angle_increment;
  double range_min, range_max;
  int64_t order;
  double rtime;  // record (receive) time — rosbag::View's sort key
  std::vector<float> ranges;
};

struct Odom {
  double stamp;
  double px, py, pz;
  double qx, qy, qz, qw;
  int64_t order;
  double rtime;
};

struct Cobot {
  double stamp;
  double dr, dx, dy;
  int64_t order;
  double rtime;
};

struct Reader {
  // Bounds-checked sequential reader: a truncated or corrupt message must
  // set `fail` and yield zeros, never read past `n` (an unchecked
  // file-controlled length here is an out-of-bounds read on hostile bags).
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool fail = false;

  bool ok(size_t k) const { return off + k <= n; }
  bool need(size_t k) {
    if (!ok(k)) {
      fail = true;
      return false;
    }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return p[off++];
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v;
    std::memcpy(&v, p + off, 4);
    off += 4;
    return v;
  }
  float f32() {
    if (!need(4)) return 0.0f;
    float v;
    std::memcpy(&v, p + off, 4);
    off += 4;
    return v;
  }
  double f64() {
    if (!need(8)) return 0.0;
    double v;
    std::memcpy(&v, p + off, 8);
    off += 8;
    return v;
  }
  std::string str() {
    uint32_t k = u32();
    if (!need(k)) return std::string();
    std::string s(reinterpret_cast<const char*>(p + off), k);
    off += k;
    return s;
  }
  void skip(size_t k) { off += k; }
};

struct HeaderFields {
  std::unordered_map<std::string, std::string> fields;
  const std::string* get(const char* k) const {
    auto it = fields.find(k);
    return it == fields.end() ? nullptr : &it->second;
  }
};

HeaderFields parse_header(const uint8_t* p, size_t n) {
  HeaderFields h;
  size_t off = 0;
  while (off + 4 <= n) {
    uint32_t flen;
    std::memcpy(&flen, p + off, 4);
    off += 4;
    if (off + flen > n) break;
    const uint8_t* field = p + off;
    const uint8_t* eq =
        static_cast<const uint8_t*>(std::memchr(field, '=', flen));
    if (eq) {
      h.fields.emplace(
          std::string(reinterpret_cast<const char*>(field), eq - field),
          std::string(reinterpret_cast<const char*>(eq + 1),
                      flen - (eq - field) - 1));
    }
    off += flen;
  }
  return h;
}

struct Bag {
  std::vector<Scan> scans;
  std::vector<Odom> odoms;
  std::vector<Cobot> cobots;
  std::string error;
};

double header_stamp(Reader& r) {
  r.u32();  // seq
  uint32_t sec = r.u32();
  uint32_t nsec = r.u32();
  r.str();  // frame_id
  return sec + nsec * 1e-9;
}

void decode_scan(const uint8_t* data, size_t n, int64_t order, double rtime,
                 Bag* bag) {
  Reader r{data, n};
  Scan s;
  s.order = order;
  s.rtime = rtime;
  s.stamp = header_stamp(r);
  s.angle_min = r.f32();
  s.angle_max = r.f32();
  s.angle_increment = r.f32();
  r.f32();  // time_increment
  r.f32();  // scan_time
  s.range_min = r.f32();
  s.range_max = r.f32();
  uint32_t k = r.u32();
  if (r.fail || !r.need(4ull * k)) {
    bag->error = "truncated LaserScan record";
    return;
  }
  s.ranges.resize(k);
  if (k) std::memcpy(s.ranges.data(), r.p + r.off, 4ull * k);
  bag->scans.push_back(std::move(s));
}

void decode_odom(const uint8_t* data, size_t n, int64_t order, double rtime,
                 Bag* bag) {
  Reader r{data, n};
  Odom o;
  o.order = order;
  o.rtime = rtime;
  o.stamp = header_stamp(r);
  r.str();  // child_frame_id
  o.px = r.f64();
  o.py = r.f64();
  o.pz = r.f64();
  o.qx = r.f64();
  o.qy = r.f64();
  o.qz = r.f64();
  o.qw = r.f64();
  if (r.fail) {
    bag->error = "truncated Odometry record";
    return;
  }
  bag->odoms.push_back(o);
}

void decode_cobot(const uint8_t* data, size_t n, int64_t order, double rtime,
                  Bag* bag) {
  Reader r{data, n};
  Cobot c;
  c.order = order;
  c.rtime = rtime;
  c.stamp = header_stamp(r);
  c.dr = r.f32();
  c.dx = r.f32();
  c.dy = r.f32();
  if (r.fail) {
    bag->error = "truncated CobotOdometryMsg record";
    return;
  }
  bag->cobots.push_back(c);
}

struct Connection {
  std::string topic;
  int type;  // 0 scan, 1 odom, 2 cobot, -1 other
};

void handle_records(const uint8_t* buf, size_t n, const std::string& lidar,
                    const std::string& odom,
                    std::unordered_map<uint32_t, Connection>* conns,
                    int64_t* order, Bag* bag, bool in_chunk);

void handle_one(const HeaderFields& h, const uint8_t* data, size_t dlen,
                const std::string& lidar, const std::string& odom,
                std::unordered_map<uint32_t, Connection>* conns,
                int64_t* order, Bag* bag) {
  const std::string* op = h.get("op");
  if (!op || op->empty()) return;
  uint8_t opc = static_cast<uint8_t>((*op)[0]);
  if (opc == 0x07) {  // connection
    const std::string* conn_s = h.get("conn");
    if (!conn_s || conn_s->size() < 4) return;
    uint32_t cid;
    std::memcpy(&cid, conn_s->data(), 4);
    HeaderFields inner = parse_header(data, dlen);
    const std::string* topic = h.get("topic");
    if (!topic) topic = inner.get("topic");
    const std::string* type = inner.get("type");
    Connection c;
    c.topic = topic ? *topic : "";
    c.type = -1;
    if (type) {
      if (*type == "sensor_msgs/LaserScan") c.type = 0;
      else if (*type == "nav_msgs/Odometry") c.type = 1;
      else if (type->size() >= 16 &&
               type->compare(type->size() - 16, 16, "CobotOdometryMsg") == 0)
        c.type = 2;
    }
    (*conns)[cid] = c;
  } else if (opc == 0x02) {  // message data
    const std::string* conn_s = h.get("conn");
    if (!conn_s || conn_s->size() < 4) return;
    uint32_t cid;
    std::memcpy(&cid, conn_s->data(), 4);
    auto it = conns->find(cid);
    if (it == conns->end()) return;
    const Connection& c = it->second;
    int64_t ord = (*order)++;
    if (c.type < 0) return;
    if (c.topic != lidar && c.topic != odom) return;
    // Record (receive) time from the record header: the rosbag::View
    // iteration key (reference main.cc:65-71 replays in this order).
    // A message record without it is malformed; report instead of
    // defaulting to 0.0, which would silently sort the message first
    // (the Python reader raises KeyError here — keep the two strict
    // in the same way).
    const std::string* time_s = h.get("time");
    if (!time_s || time_s->size() < 8) {
      bag->error = "message data record missing 'time' header field";
      return;
    }
    uint32_t sec, nsec;
    std::memcpy(&sec, time_s->data(), 4);
    std::memcpy(&nsec, time_s->data() + 4, 4);
    double rtime = sec + nsec * 1e-9;
    switch (c.type) {
      case 0: decode_scan(data, dlen, ord, rtime, bag); break;
      case 1: decode_odom(data, dlen, ord, rtime, bag); break;
      case 2: decode_cobot(data, dlen, ord, rtime, bag); break;
    }
  } else if (opc == 0x05) {  // chunk
    const std::string* comp = h.get("compression");
    if (!comp || *comp == "none") {
      handle_records(data, dlen, lidar, odom, conns, order, bag, true);
    } else if (*comp == "bz2") {
      const std::string* size_s = h.get("size");
      uint32_t usize = 0;
      if (size_s && size_s->size() >= 4) std::memcpy(&usize, size_s->data(), 4);
      if (!usize) usize = static_cast<uint32_t>(dlen) * 12 + (1u << 20);
      std::vector<char> out(usize);
      unsigned outLen = usize;
      int rc = BZ2_bzBuffToBuffDecompress(
          out.data(), &outLen, const_cast<char*>(
              reinterpret_cast<const char*>(data)),
          static_cast<unsigned>(dlen), 0, 0);
      if (rc == 0) {
        handle_records(reinterpret_cast<const uint8_t*>(out.data()), outLen,
                       lidar, odom, conns, order, bag, true);
      } else {
        bag->error = "bz2 decompression failed";
      }
#ifndef NTBAG_NO_LZ4
    } else if (*comp == "lz4") {
      std::vector<char> out;
      const std::string* size_s = h.get("size");
      uint32_t usize = 0;
      if (size_s && size_s->size() >= 4) std::memcpy(&usize, size_s->data(), 4);
      out.reserve(usize);
      if (lz4_frame_decompress(data, dlen, &out)) {
        handle_records(reinterpret_cast<const uint8_t*>(out.data()),
                       out.size(), lidar, odom, conns, order, bag, true);
      } else {
        bag->error = "lz4 decompression failed";
      }
#endif
    } else {
      bag->error = "unsupported chunk compression: " + *comp;
    }
  }
}

void handle_records(const uint8_t* buf, size_t n, const std::string& lidar,
                    const std::string& odom,
                    std::unordered_map<uint32_t, Connection>* conns,
                    int64_t* order, Bag* bag, bool in_chunk) {
  size_t off = 0;
  while (off + 4 <= n) {
    uint32_t hlen;
    std::memcpy(&hlen, buf + off, 4);
    off += 4;
    if (off + hlen + 4 > n) break;
    HeaderFields h = parse_header(buf + off, hlen);
    off += hlen;
    uint32_t dlen;
    std::memcpy(&dlen, buf + off, 4);
    off += 4;
    if (off + dlen > n) break;
    handle_one(h, buf + off, dlen, lidar, odom, conns, order, bag);
    off += dlen;
  }
}

}  // namespace

extern "C" {

void* nt_bag_parse(const char* path, const char* lidar_topic,
                   const char* odom_topic) {
  FILE* f = std::fopen(path, "rb");
  Bag* bag = new Bag();
  if (!f) {
    bag->error = "cannot open file";
    return bag;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    bag->error = "short read";
    std::fclose(f);
    return bag;
  }
  std::fclose(f);
  const char magic[] = "#ROSBAG V2.0\n";
  size_t mlen = sizeof(magic) - 1;
  if (size < static_cast<long>(mlen) ||
      std::memcmp(buf.data(), magic, mlen) != 0) {
    bag->error = "not a ROS bag v2.0 file";
    return bag;
  }
  std::unordered_map<uint32_t, Connection> conns;
  int64_t order = 0;
  handle_records(buf.data() + mlen, size - mlen, lidar_topic, odom_topic,
                 &conns, &order, bag, false);
  return bag;
}

const char* nt_bag_error(void* h) {
  Bag* bag = static_cast<Bag*>(h);
  return bag->error.c_str();
}

long nt_bag_num_scans(void* h) { return static_cast<Bag*>(h)->scans.size(); }
long nt_bag_num_odoms(void* h) { return static_cast<Bag*>(h)->odoms.size(); }
long nt_bag_num_cobots(void* h) { return static_cast<Bag*>(h)->cobots.size(); }

// meta: [stamp, angle_min, angle_max, angle_increment, range_min, range_max,
//        nranges, order, rtime]
void nt_bag_scan_meta(void* h, long i, double* meta) {
  const Scan& s = static_cast<Bag*>(h)->scans[i];
  meta[0] = s.stamp;
  meta[1] = s.angle_min;
  meta[2] = s.angle_max;
  meta[3] = s.angle_increment;
  meta[4] = s.range_min;
  meta[5] = s.range_max;
  meta[6] = static_cast<double>(s.ranges.size());
  meta[7] = static_cast<double>(s.order);
  meta[8] = s.rtime;
}

void nt_bag_scan_ranges(void* h, long i, float* out) {
  const Scan& s = static_cast<Bag*>(h)->scans[i];
  std::memcpy(out, s.ranges.data(), 4 * s.ranges.size());
}

// Batched variants: one call for every scan, so the Python wrapper pays
// two ctypes round-trips instead of 2*n_scans.  meta_all writes [n, 9]
// rows in nt_bag_scan_meta order; ranges_all concatenates all range
// arrays (caller sizes the buffer from the meta nranges column and
// splits on its prefix sums).
void nt_bag_scan_meta_all(void* h, double* out) {
  Bag* bag = static_cast<Bag*>(h);
  for (size_t i = 0; i < bag->scans.size(); i++)
    nt_bag_scan_meta(h, static_cast<long>(i), out + 9 * i);
}

void nt_bag_scan_ranges_all(void* h, float* out) {
  Bag* bag = static_cast<Bag*>(h);
  for (const Scan& s : bag->scans) {
    std::memcpy(out, s.ranges.data(), 4 * s.ranges.size());
    out += s.ranges.size();
  }
}

// out rows: [stamp, px, py, pz, qx, qy, qz, qw, order, rtime]
void nt_bag_odoms(void* h, double* out) {
  Bag* bag = static_cast<Bag*>(h);
  for (size_t i = 0; i < bag->odoms.size(); i++) {
    const Odom& o = bag->odoms[i];
    double* r = out + 10 * i;
    r[0] = o.stamp; r[1] = o.px; r[2] = o.py; r[3] = o.pz;
    r[4] = o.qx; r[5] = o.qy; r[6] = o.qz; r[7] = o.qw;
    r[8] = static_cast<double>(o.order);
    r[9] = o.rtime;
  }
}

// out rows: [stamp, dr, dx, dy, order, rtime]
void nt_bag_cobots(void* h, double* out) {
  Bag* bag = static_cast<Bag*>(h);
  for (size_t i = 0; i < bag->cobots.size(); i++) {
    const Cobot& c = bag->cobots[i];
    double* r = out + 6 * i;
    r[0] = c.stamp; r[1] = c.dr; r[2] = c.dx; r[3] = c.dy;
    r[4] = static_cast<double>(c.order);
    r[5] = c.rtime;
  }
}

void nt_bag_free(void* h) { delete static_cast<Bag*>(h); }

}  // extern "C"
