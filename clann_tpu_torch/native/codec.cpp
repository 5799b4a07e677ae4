// Native reference-format index codec (C ABI, loaded via ctypes).
//
// TPU-native equivalent of the reference's native FFI layer
// (reference: libpuffinn-ffi/c_binder.{h,cpp} — the C ABI bridge between
// index bytes and the engine). Where the reference shim wraps a live C++
// PUFFINN object, this codec translates between the reference's versioned
// binary index stream (SURVEY.md §3.3) and flat arrays the JAX engine
// consumes, enabling interop: read an index produced by the Rust/C++
// reference, and write one it can load.
//
// Stream layout implemented (CosineSimilarity, independent hash source —
// the reference defaults; little-endian, size_t = 8 bytes):
//   Index            := Dataset Filterer HashArgs has_source:u8 [Source]
//                       num_maps:u64 use_chunks:u8 PrefixMap* last_rebuild:u32
//                       (collection.hpp:147-209)
//   Dataset          := dims:u32 storage_len:u32 n:u32 data:i16[n*storage_len]
//                       (dataset.hpp:68-86, format/unit_vector.hpp Q15)
//   Filterer         := HashArgs Source len:u64 sketches:u64[len]
//                       (filterer.hpp:52-69)
//   HashArgs         := type:u32(0=independent) FamilyArgs
//                       (hash_source/deserialize.hpp:10-23,
//                        independent.hpp:135-139)
//   FamilyArgs(SimHash)  := (empty)              (simhash.hpp:49-59)
//   FamilyArgs(FHT-CP)   := num_rotations:i32 est_reps:u32 est_eps:f32
//                       (crosspolytope.hpp:225-240)
//   Source           := Family funcs:u64 Function* num_hashers:u32
//                       fph:u32 bits_per_function:u8 next_function:u32
//                       bits_to_cut:u32          (independent.hpp:40-68)
//   Family(SimHash)  := dims:u32 storage_len:u32 (DatasetDescription,
//                       generic.hpp:21-24)
//   Family(FHT-CP)   := dims:u32 storage_len:u32 FamilyArgs Estimates
//   Estimates        := d1:u64 { d2:u64 probs:f32[d2] }* eps:f32
//                       (crosspolytope.hpp:91-115)
//   Function(SimHash):= dims:u32 plane:i16[dims]  (simhash.hpp:25-38)
//   Function(FHT-CP) := dims:i32 log_dims:i32 rots:u32
//                       signs:i8[rots<<log_dims] (crosspolytope.hpp:165-184)
//   PrefixMap        := len:u64 indices:u32[len] hashes:u32[len]
//                       rebuilding:u64(=0) hash_length:u32
//                       prefix_index:u32[8193]   (prefixmap.hpp:99-153)
//
// Build: make -C clann_tpu/native   ->  libclann_codec.so

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMaxHashbits = 24;     // typedefs.hpp:13
constexpr uint32_t kPrefixIndexLen = (1u << 13) + 1;  // prefixmap.hpp:70,86

enum FamilyKind : int32_t {
  kFamilySimHash = 0,
  kFamilyFhtCrossPolytope = 1,
  kFamilyCrossPolytope = 2,    // vanilla CP (crosspolytope.hpp:313-469)
  kFamilyMinHash = 3,          // Jaccard tables (minhash.hpp:97-220)
  kFamilyMinHash1Bit = 4,      // Jaccard sketches (minhash.hpp:223-283)
};

enum SourceKind : int32_t {    // HashSourceType (hash_source.hpp:6-10)
  kSourceIndependent = 0,
  kSourcePool = 1,
  kSourceTensor = 2,
};

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool take(void* out, size_t len) {
    if (!ok || p + len > end) { ok = false; return false; }
    std::memcpy(out, p, len);
    p += len;
    return true;
  }
  template <typename T> T get() { T v{}; take(&v, sizeof(T)); return v; }
  bool skip(size_t len) {
    if (!ok || p + len > end) { ok = false; return false; }
    p += len;
    return true;
  }
};

struct Writer {
  std::vector<uint8_t> buf;
  void put(const void* src, size_t len) {
    const uint8_t* s = static_cast<const uint8_t*>(src);
    buf.insert(buf.end(), s, s + len);
  }
  template <typename T> void set(T v) { put(&v, sizeof(T)); }
};

struct SimHashFn {
  std::vector<int16_t> plane;  // storage_len entries
};

struct FhtFn {
  int32_t dims = 0;
  int32_t log_dims = 0;
  uint32_t rotations = 0;
  std::vector<int8_t> signs;
};

struct SourceInfo {
  uint32_t num_hashers = 0;
  uint32_t functions_per_hasher = 0;
  uint8_t bits_per_function = 0;
  uint32_t next_function = 0;
  uint32_t bits_to_cut = 0;
};

struct CpFn {  // crosspolytope.hpp:338-354
  uint32_t dims = 0;
  uint32_t padded_dims = 0;
  std::vector<int16_t> matrix;  // (1 << ceil_log(dims)) * padded_dims Q15
};

struct MinHashFn {  // minhash.hpp:105-113 = TabulationHash + BitPermutation
  std::vector<uint64_t> tabs;   // 4 x 256 (minhash.hpp:27-38)
  uint32_t perm_bits = 0;       // BitPermutation.num_bits
  std::vector<uint32_t> perm;   // (minhash.hpp:66-83)
};

// HashArgs record: type tag + family-specific args (+ pool_size for Pool)
// as read/written at the filterer and index HashArgs positions
// (deserialize.hpp:10-23).
struct ArgsRecord {
  int32_t source_kind = kSourceIndependent;
  int32_t num_rotations = 3;    // FHT-CP only (crosspolytope.hpp:225-240)
  uint32_t est_reps = 0;        // CP family args
  float est_eps = 0.f;
  uint32_t mh_rand_bits = 0;    // MinHashArgs (minhash.hpp:146-152)
  uint32_t pool_size = 0;       // HashPoolArgs (pool.hpp:199-220)
};

// One parsed hash source of any (family x kind) combination, retaining
// every stream field so re-emission is byte-identical.
struct SourceBlock {
  int32_t family = kFamilySimHash;
  int32_t kind = kSourceIndependent;
  // family header (serialized at the start of the source stream)
  uint32_t fam_dims = 0, fam_storage_len = 0;  // DatasetDescription
  int32_t num_rotations = 3;
  uint32_t est_reps = 0;
  float est_eps = 0.f;
  std::vector<float> estimates;
  std::vector<uint64_t> est_row_len;
  uint32_t mh_rand_bits = 0, mh_set_size = 0;  // MinHash family
  // functions (one vector used, per family)
  std::vector<SimHashFn> sim_fns;
  std::vector<FhtFn> fht_fns;
  std::vector<CpFn> cp_fns;
  std::vector<MinHashFn> mh_fns;
  // independent tail (also the embedded source of a tensor)
  SourceInfo info;
  // pool tail (pool.hpp:57-85)
  std::vector<std::vector<uint32_t>> pool_indices;
  uint32_t pool_num_tables = 0, pool_bits_per_hasher = 0;
  uint32_t pool_sampling_rep = 0, pool_bits_to_cut = 0;
  uint8_t pool_bits_per_function = 0;
  // tensor tail (tensor.hpp:64-78)
  uint32_t tens_num_hashers = 0, tens_next_idx = 0, tens_num_bits = 0;

  size_t num_fns() const {
    return sim_fns.size() + fht_fns.size() + cp_fns.size() + mh_fns.size();
  }
};

struct ParsedIndex {
  // dataset (UnitVectorFormat, or SetFormat for MinHash-family indexes)
  uint32_t dims = 0;         // dims (cosine) or universe size (jaccard)
  uint32_t storage_len = 0;  // padded dims (cosine) or 1 (jaccard)
  uint32_t n = 0;
  std::vector<int16_t> data;      // n * storage_len Q15 (cosine)
  std::vector<uint64_t> set_lens; // per-point token counts (jaccard)
  std::vector<uint32_t> set_tokens;  // concatenated sorted tokens (jaccard)
  // sketches
  std::vector<uint64_t> sketches;  // n * NUM_SKETCHES
  ArgsRecord sketch_args;
  SourceBlock sketch_src;
  // table hash machinery
  int32_t family = kFamilySimHash;
  ArgsRecord hash_args;
  SourceBlock hash_src;
  bool has_hash_source = false;
  // tables
  std::vector<std::vector<uint32_t>> map_indices;
  std::vector<std::vector<uint32_t>> map_hashes;
  std::vector<uint32_t> map_hash_length;
  uint32_t last_rebuild = 0;
  // chunked serialization (collection.hpp:178-209, use_chunks=true): the
  // main stream carries num_maps but no inline PrefixMaps; each map arrives
  // as its own chunk stream (one PrefixMap::serialize each,
  // collection.hpp:171-176)
  bool chunked = false;
  uint64_t expected_maps = 0;
  std::string error;
};

// sketch family implied by the table family: SimHash for cosine indexes
// (cosine.hpp:17), MinHash1Bit for jaccard (jaccard.hpp defaults).
int32_t sketch_family_for(int32_t family) {
  return family == kFamilyMinHash ? kFamilyMinHash1Bit : kFamilySimHash;
}

bool read_dataset(Reader& r, ParsedIndex& ix) {
  ix.dims = r.get<uint32_t>();         // Format::Args (dims / universe)
  ix.storage_len = r.get<uint32_t>();
  ix.n = r.get<uint32_t>();
  if (ix.family == kFamilyMinHash) {
    // SetFormat: per point len:u64 tokens:u32[len] (set.hpp:70-99,
    // dataset.hpp:79-86); storage_len is 1
    ix.set_lens.reserve(ix.n);
    for (uint32_t i = 0; i < ix.n && r.ok; i++) {
      uint64_t len = r.get<uint64_t>();
      ix.set_lens.push_back(len);
      size_t off = ix.set_tokens.size();
      ix.set_tokens.resize(off + len);
      if (len) r.take(ix.set_tokens.data() + off, size_t(len) * 4);
    }
  } else {
    ix.data.resize(size_t(ix.n) * ix.storage_len);
    if (!ix.data.empty()) r.take(ix.data.data(), ix.data.size() * 2);
  }
  return r.ok;
}

// Monte-Carlo estimate table shared by both CP families
// (CrossPolytopeCollisionEstimates, crosspolytope.hpp:91-115).
bool read_estimates(Reader& r, SourceBlock& s) {
  uint64_t d1 = r.get<uint64_t>();
  s.estimates.clear();
  s.est_row_len.clear();
  for (uint64_t i = 0; i < d1 && r.ok; i++) {
    uint64_t d2 = r.get<uint64_t>();
    s.est_row_len.push_back(d2);
    size_t off = s.estimates.size();
    s.estimates.resize(off + d2);
    if (d2) r.take(s.estimates.data() + off, d2 * 4);
  }
  r.get<float>();  // eps (repeated inside the estimates struct)
  return r.ok;
}

// Family header at the start of a source stream: the hash family object's
// own serialization (simhash.hpp:49-59, crosspolytope.hpp:225-240 /
// 442-452, minhash.hpp:185-199).
bool read_family_header(Reader& r, int32_t family, SourceBlock& s) {
  s.family = family;
  switch (family) {
    case kFamilySimHash:
      s.fam_dims = r.get<uint32_t>();
      s.fam_storage_len = r.get<uint32_t>();
      return r.ok;
    case kFamilyFhtCrossPolytope:
      s.fam_dims = r.get<uint32_t>();
      s.fam_storage_len = r.get<uint32_t>();
      s.num_rotations = r.get<int32_t>();
      s.est_reps = r.get<uint32_t>();
      s.est_eps = r.get<float>();
      return read_estimates(r, s);
    case kFamilyCrossPolytope:
      s.fam_dims = r.get<uint32_t>();
      s.fam_storage_len = r.get<uint32_t>();
      s.est_reps = r.get<uint32_t>();
      s.est_eps = r.get<float>();
      return read_estimates(r, s);
    case kFamilyMinHash:
    case kFamilyMinHash1Bit:
      // MinHash serializes args + set_size, NO DatasetDescription
      // (minhash.hpp:191-199)
      s.mh_rand_bits = r.get<uint32_t>();
      s.mh_set_size = r.get<uint32_t>();
      return r.ok;
  }
  return false;
}

bool read_function(Reader& r, int32_t family, SourceBlock& s) {
  switch (family) {
    case kFamilySimHash: {
      SimHashFn f;
      uint32_t d = r.get<uint32_t>();
      f.plane.resize(d);
      if (d) r.take(f.plane.data(), size_t(d) * 2);
      s.sim_fns.push_back(std::move(f));
      return r.ok;
    }
    case kFamilyFhtCrossPolytope: {
      FhtFn f;
      f.dims = r.get<int32_t>();
      f.log_dims = r.get<int32_t>();
      f.rotations = r.get<uint32_t>();
      size_t signs_len = size_t(f.rotations) << f.log_dims;
      f.signs.resize(signs_len);
      if (signs_len) r.take(f.signs.data(), signs_len);
      s.fht_fns.push_back(std::move(f));
      return r.ok;
    }
    case kFamilyCrossPolytope: {
      CpFn f;
      f.dims = r.get<uint32_t>();
      f.padded_dims = r.get<uint32_t>();
      uint32_t rows = 1;
      while (rows < f.dims) rows <<= 1;  // 1 << ceil_log (math.hpp:105-113)
      f.matrix.resize(size_t(rows) * f.padded_dims);
      if (!f.matrix.empty()) r.take(f.matrix.data(), f.matrix.size() * 2);
      s.cp_fns.push_back(std::move(f));
      return r.ok;
    }
    case kFamilyMinHash:
    case kFamilyMinHash1Bit: {
      MinHashFn f;
      f.tabs.resize(4 * 256);
      r.take(f.tabs.data(), f.tabs.size() * 8);
      f.perm_bits = r.get<uint32_t>();
      uint64_t len = r.get<uint64_t>();
      f.perm.resize(len);
      if (len) r.take(f.perm.data(), size_t(len) * 4);
      s.mh_fns.push_back(std::move(f));
      return r.ok;
    }
  }
  return false;
}

bool read_independent_body(Reader& r, int32_t family, SourceBlock& s) {
  // IndependentHashSource (independent.hpp:40-55)
  if (!read_family_header(r, family, s)) return false;
  uint64_t len = r.get<uint64_t>();
  for (uint64_t i = 0; i < len && r.ok; i++) {
    if (!read_function(r, family, s)) return false;
  }
  s.info.num_hashers = r.get<uint32_t>();
  s.info.functions_per_hasher = r.get<uint32_t>();
  s.info.bits_per_function = r.get<uint8_t>();
  s.info.next_function = r.get<uint32_t>();
  s.info.bits_to_cut = r.get<uint32_t>();
  return r.ok;
}

bool read_source(Reader& r, int32_t family, int32_t kind, SourceBlock& s) {
  s.kind = kind;
  switch (kind) {
    case kSourceIndependent:
      return read_independent_body(r, family, s);
    case kSourcePool: {
      // HashPool (pool.hpp:57-85)
      if (!read_family_header(r, family, s)) return false;
      uint64_t len = r.get<uint64_t>();
      for (uint64_t i = 0; i < len && r.ok; i++) {
        if (!read_function(r, family, s)) return false;
      }
      uint64_t len_indices = r.get<uint64_t>();
      for (uint64_t i = 0; i < len_indices && r.ok; i++) {
        uint64_t li = r.get<uint64_t>();
        std::vector<uint32_t> rep(li);
        if (li) r.take(rep.data(), size_t(li) * 4);
        s.pool_indices.push_back(std::move(rep));
      }
      s.pool_num_tables = r.get<uint32_t>();
      s.pool_bits_per_function = r.get<uint8_t>();
      s.pool_bits_per_hasher = r.get<uint32_t>();
      s.pool_sampling_rep = r.get<uint32_t>();
      s.pool_bits_to_cut = r.get<uint32_t>();
      return r.ok;
    }
    case kSourceTensor:
      // TensoredHashSource = embedded independent source + tail
      // (tensor.hpp:64-78)
      if (!read_independent_body(r, family, s)) return false;
      s.tens_num_hashers = r.get<uint32_t>();
      s.tens_next_idx = r.get<uint32_t>();
      s.tens_num_bits = r.get<uint32_t>();
      return r.ok;
  }
  return false;
}

// HashArgs record: type:u32 + family args (+ pool_size for Pool)
// (deserialize.hpp:10-23, pool.hpp:207-220).
bool read_args_record(Reader& r, int32_t family, ArgsRecord& a) {
  a.source_kind = static_cast<int32_t>(r.get<uint32_t>());
  if (a.source_kind < 0 || a.source_kind > kSourceTensor) return false;
  switch (family) {
    case kFamilySimHash:
      break;  // SimHashArgs serialize as nothing (simhash.hpp:49-59)
    case kFamilyFhtCrossPolytope:
      a.num_rotations = r.get<int32_t>();
      a.est_reps = r.get<uint32_t>();
      a.est_eps = r.get<float>();
      break;
    case kFamilyCrossPolytope:
      a.est_reps = r.get<uint32_t>();
      a.est_eps = r.get<float>();
      break;
    case kFamilyMinHash:
    case kFamilyMinHash1Bit:
      a.mh_rand_bits = r.get<uint32_t>();
      break;
    default:
      return false;
  }
  if (a.source_kind == kSourcePool) a.pool_size = r.get<uint32_t>();
  return r.ok;
}

bool read_filterer(Reader& r, ParsedIndex& ix) {
  int32_t sk_family = sketch_family_for(ix.family);
  if (!read_args_record(r, sk_family, ix.sketch_args)) {
    ix.error = "unsupported sketch source type";
    return false;
  }
  if (!read_source(r, sk_family, ix.sketch_args.source_kind, ix.sketch_src))
    return false;
  uint64_t len = r.get<uint64_t>();
  ix.sketches.resize(len);
  if (len) r.take(ix.sketches.data(), len * 8);
  return r.ok;
}

bool read_prefix_map(Reader& r, ParsedIndex& ix) {
  uint64_t len = r.get<uint64_t>();
  std::vector<uint32_t> idx(len), hsh(len);
  if (len) {
    r.take(idx.data(), len * 4);
    r.take(hsh.data(), len * 4);
  }
  uint64_t rebuilding = r.get<uint64_t>();
  r.skip(rebuilding * 8);  // HashedVecIdx = {u32 hash, u32 idx}
  uint32_t hash_length = r.get<uint32_t>();
  r.skip(size_t(kPrefixIndexLen) * 4);
  if (!r.ok) return false;
  // Strip the SEGMENT_SIZE sentinel padding (hash == 0xffffffff) the
  // reference adds on both ends (prefixmap.hpp:209-226); real 24-bit
  // hashes can never equal the sentinel.
  std::vector<uint32_t> cidx, chsh;
  cidx.reserve(idx.size());
  chsh.reserve(hsh.size());
  for (size_t i = 0; i < hsh.size(); i++) {
    if (hsh[i] != 0xffffffffu) {
      cidx.push_back(idx[i]);
      chsh.push_back(hsh[i]);
    }
  }
  ix.map_indices.push_back(std::move(cidx));
  ix.map_hashes.push_back(std::move(chsh));
  ix.map_hash_length.push_back(hash_length);
  return true;
}

// Serializes one PrefixMap: sentinel padding on both ends plus a correct
// 13-bit prefix directory so the reference can query the map without a
// rebuild (prefixmap.hpp:99-153,209-240).
void write_map(Writer* out, uint64_t len, const uint32_t* indices,
               const uint32_t* hashes) {
  constexpr int kSegmentSize = 12;  // prefixmap.hpp:60
  uint64_t padded = len + 2 * kSegmentSize;
  out->set<uint64_t>(padded);
  std::vector<uint32_t> idx(padded, 0), hsh(padded, 0xffffffffu);
  if (len) {
    std::memcpy(idx.data() + kSegmentSize, indices, len * 4);
    std::memcpy(hsh.data() + kSegmentSize, hashes, len * 4);
  }
  out->put(idx.data(), padded * 4);
  out->put(hsh.data(), padded * 4);
  out->set<uint64_t>(0);  // rebuilding_len
  out->set<uint32_t>(kMaxHashbits);  // hash_length
  std::vector<uint32_t> dir(kPrefixIndexLen, 0);
  uint64_t cursor = 0;
  for (uint32_t prefix = 0; prefix < (kPrefixIndexLen - 1); prefix++) {
    while (cursor < len &&
           (hashes[cursor] >> (kMaxHashbits - 13)) < prefix) {
      cursor++;
    }
    dir[prefix] = kSegmentSize + static_cast<uint32_t>(cursor);
  }
  dir[kPrefixIndexLen - 1] = kSegmentSize + static_cast<uint32_t>(len);
  out->put(dir.data(), dir.size() * 4);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- parse --

void* clann_ref_parse(const uint8_t* buf, uint64_t len, int32_t family) {
  auto* ix = new ParsedIndex();
  ix->family = family;
  Reader r{buf, buf + len};
  do {
    if (!read_dataset(r, *ix)) { ix->error = "dataset"; break; }
    if (!read_filterer(r, *ix)) {
      if (ix->error.empty()) ix->error = "filterer";
      break;
    }
    if (!read_args_record(r, family, ix->hash_args)) {
      ix->error = "unsupported hash source type";
      break;
    }
    uint8_t has_source = r.get<uint8_t>();
    ix->has_hash_source = has_source != 0;
    if (ix->has_hash_source) {
      if (!read_source(r, family, ix->hash_args.source_kind, ix->hash_src)) {
        ix->error = "hash source";
        break;
      }
    }
    uint64_t num_maps = r.get<uint64_t>();
    uint8_t use_chunks = r.get<uint8_t>();
    ix->chunked = use_chunks != 0;
    ix->expected_maps = num_maps;
    if (!use_chunks) {
      for (uint64_t i = 0; i < num_maps; i++) {
        if (!read_prefix_map(r, *ix)) { ix->error = "prefix map"; break; }
      }
    }
    if (!ix->error.empty()) break;
    ix->last_rebuild = r.get<uint32_t>();
    if (!r.ok) ix->error = "truncated stream";
  } while (false);
  return ix;
}

// Parses one PrefixMap chunk stream into a chunked-parsed index (the
// counterpart of Index::deserialize_chunk, collection.hpp:171-176).
// Returns 1 on success, 0 on failure (error retrievable via clann_ref_error).
int32_t clann_ref_parse_chunk(void* h, const uint8_t* buf, uint64_t len) {
  auto* ix = static_cast<ParsedIndex*>(h);
  Reader r{buf, buf + len};
  if (!read_prefix_map(r, *ix)) {
    ix->error = "prefix map chunk";
    return 0;
  }
  return 1;
}

uint32_t clann_ref_is_chunked(void* h) {
  return static_cast<ParsedIndex*>(h)->chunked ? 1 : 0;
}
uint64_t clann_ref_expected_maps(void* h) {
  return static_cast<ParsedIndex*>(h)->expected_maps;
}

void clann_ref_free(void* h) { delete static_cast<ParsedIndex*>(h); }

const char* clann_ref_error(void* h) {
  auto* ix = static_cast<ParsedIndex*>(h);
  return ix->error.empty() ? nullptr : ix->error.c_str();
}

uint32_t clann_ref_dims(void* h) { return static_cast<ParsedIndex*>(h)->dims; }
uint32_t clann_ref_storage_len(void* h) {
  return static_cast<ParsedIndex*>(h)->storage_len;
}
uint32_t clann_ref_num_points(void* h) {
  return static_cast<ParsedIndex*>(h)->n;
}
uint32_t clann_ref_num_maps(void* h) {
  return static_cast<uint32_t>(static_cast<ParsedIndex*>(h)->map_indices.size());
}
uint32_t clann_ref_last_rebuild(void* h) {
  return static_cast<ParsedIndex*>(h)->last_rebuild;
}
const int16_t* clann_ref_data(void* h) {
  return static_cast<ParsedIndex*>(h)->data.data();
}
uint64_t clann_ref_num_sketches(void* h) {
  return static_cast<ParsedIndex*>(h)->sketches.size();
}
const uint64_t* clann_ref_sketches(void* h) {
  return static_cast<ParsedIndex*>(h)->sketches.data();
}
uint64_t clann_ref_map_len(void* h, uint32_t i) {
  return static_cast<ParsedIndex*>(h)->map_indices[i].size();
}
const uint32_t* clann_ref_map_indices(void* h, uint32_t i) {
  return static_cast<ParsedIndex*>(h)->map_indices[i].data();
}
const uint32_t* clann_ref_map_hashes(void* h, uint32_t i) {
  return static_cast<ParsedIndex*>(h)->map_hashes[i].data();
}
uint32_t clann_ref_map_hash_length(void* h, uint32_t i) {
  return static_cast<ParsedIndex*>(h)->map_hash_length[i];
}
uint32_t clann_ref_num_sketch_fns(void* h) {
  return static_cast<uint32_t>(
      static_cast<ParsedIndex*>(h)->sketch_src.num_fns());
}
const int16_t* clann_ref_sketch_fn_plane(void* h, uint32_t i, uint32_t* len) {
  auto& f = static_cast<ParsedIndex*>(h)->sketch_src.sim_fns[i];
  *len = static_cast<uint32_t>(f.plane.size());
  return f.plane.data();
}
uint32_t clann_ref_num_hash_fns(void* h) {
  return static_cast<uint32_t>(
      static_cast<ParsedIndex*>(h)->hash_src.num_fns());
}
const int16_t* clann_ref_hash_fn_plane(void* h, uint32_t i, uint32_t* len) {
  auto& f = static_cast<ParsedIndex*>(h)->hash_src.sim_fns[i];
  *len = static_cast<uint32_t>(f.plane.size());
  return f.plane.data();
}
const int8_t* clann_ref_hash_fn_signs(void* h, uint32_t i, int32_t* log_dims,
                                      uint32_t* rotations) {
  auto& f = static_cast<ParsedIndex*>(h)->hash_src.fht_fns[i];
  *log_dims = f.log_dims;
  *rotations = f.rotations;
  return f.signs.data();
}
// Parsed FHT-CP Monte-Carlo collision estimates (crosspolytope.hpp:10-119),
// exposed so a faithful re-export can pass the reference's own table back
// through instead of re-tabulating (which could never be byte-identical —
// the reference samples them from its clock-seeded RNG). Returns 1 and the
// (rows, cols) shape when present and rectangular; 0 otherwise.
uint32_t clann_ref_est_info(void* h, uint32_t* reps, float* eps,
                            uint32_t* rows, uint32_t* cols) {
  auto& s = static_cast<ParsedIndex*>(h)->hash_src;
  if (s.est_row_len.empty()) return 0;
  uint64_t c = s.est_row_len[0];
  for (uint64_t len : s.est_row_len) {
    if (len != c) return 0;
  }
  *reps = s.est_reps;
  *eps = s.est_eps;
  *rows = static_cast<uint32_t>(s.est_row_len.size());
  *cols = static_cast<uint32_t>(c);
  return 1;
}
const float* clann_ref_est_data(void* h) {
  return static_cast<ParsedIndex*>(h)->hash_src.estimates.data();
}
int32_t clann_ref_num_rotations(void* h) {
  return static_cast<ParsedIndex*>(h)->hash_src.num_rotations;
}
void clann_ref_source_info(void* h, uint32_t* num_hashers, uint32_t* fph,
                           uint32_t* bits_per_fn, uint32_t* bits_to_cut) {
  auto& s = static_cast<ParsedIndex*>(h)->hash_src.info;
  *num_hashers = s.num_hashers;
  *fph = s.functions_per_hasher;
  *bits_per_fn = s.bits_per_function;
  *bits_to_cut = s.bits_to_cut;
}

// ------------------------------------------------- extended accessors --
// (pool/tensor sources, vanilla-CP + MinHash functions, set datasets)

int32_t clann_ref_source_kind(void* h) {
  return static_cast<ParsedIndex*>(h)->hash_args.source_kind;
}
// Index-level HashArgs record (pool_size is only meaningful for Pool).
void clann_ref_args_info(void* h, int32_t* num_rotations, uint32_t* est_reps,
                         float* est_eps, uint32_t* mh_rand_bits,
                         uint32_t* pool_size) {
  auto& a = static_cast<ParsedIndex*>(h)->hash_args;
  *num_rotations = a.num_rotations;
  *est_reps = a.est_reps;
  *est_eps = a.est_eps;
  *mh_rand_bits = a.mh_rand_bits;
  *pool_size = a.pool_size;
}
void clann_ref_sketch_args_info(void* h, uint32_t* mh_rand_bits) {
  *mh_rand_bits = static_cast<ParsedIndex*>(h)->sketch_args.mh_rand_bits;
}
// Pool tail (pool.hpp:79-84). Returns number of per-table index vectors.
uint32_t clann_ref_pool_info(void* h, uint32_t* num_tables,
                             uint32_t* bits_per_function,
                             uint32_t* bits_per_hasher,
                             uint32_t* sampling_rep, uint32_t* bits_to_cut) {
  auto& s = static_cast<ParsedIndex*>(h)->hash_src;
  *num_tables = s.pool_num_tables;
  *bits_per_function = s.pool_bits_per_function;
  *bits_per_hasher = s.pool_bits_per_hasher;
  *sampling_rep = s.pool_sampling_rep;
  *bits_to_cut = s.pool_bits_to_cut;
  return static_cast<uint32_t>(s.pool_indices.size());
}
const uint32_t* clann_ref_pool_indices(void* h, uint32_t i, uint64_t* len) {
  auto& v = static_cast<ParsedIndex*>(h)->hash_src.pool_indices[i];
  *len = v.size();
  return v.data();
}
// Tensor tail (tensor.hpp:74-78).
void clann_ref_tensor_info(void* h, uint32_t* num_hashers,
                           uint32_t* next_idx, uint32_t* num_bits) {
  auto& s = static_cast<ParsedIndex*>(h)->hash_src;
  *num_hashers = s.tens_num_hashers;
  *next_idx = s.tens_next_idx;
  *num_bits = s.tens_num_bits;
}
// Family header of the hash source (dims/storage for cosine families;
// rand_bits/set_size for MinHash).
void clann_ref_family_info(void* h, uint32_t* fam_dims,
                           uint32_t* fam_storage_len, uint32_t* mh_rand_bits,
                           uint32_t* mh_set_size) {
  auto& s = static_cast<ParsedIndex*>(h)->hash_src;
  *fam_dims = s.fam_dims;
  *fam_storage_len = s.fam_storage_len;
  *mh_rand_bits = s.mh_rand_bits;
  *mh_set_size = s.mh_set_size;
}
void clann_ref_sketch_family_info(void* h, uint32_t* mh_rand_bits,
                                  uint32_t* mh_set_size) {
  auto& s = static_cast<ParsedIndex*>(h)->sketch_src;
  *mh_rand_bits = s.mh_rand_bits;
  *mh_set_size = s.mh_set_size;
}
const int16_t* clann_ref_hash_fn_cp(void* h, uint32_t i, uint32_t* dims,
                                    uint32_t* padded, uint64_t* len) {
  auto& f = static_cast<ParsedIndex*>(h)->hash_src.cp_fns[i];
  *dims = f.dims;
  *padded = f.padded_dims;
  *len = f.matrix.size();
  return f.matrix.data();
}
const uint64_t* clann_ref_mh_fn_tabs(void* h, uint32_t sketch, uint32_t i) {
  auto* ix = static_cast<ParsedIndex*>(h);
  auto& s = sketch ? ix->sketch_src : ix->hash_src;
  return s.mh_fns[i].tabs.data();
}
const uint32_t* clann_ref_mh_fn_perm(void* h, uint32_t sketch, uint32_t i,
                                     uint32_t* perm_bits, uint64_t* len) {
  auto* ix = static_cast<ParsedIndex*>(h);
  auto& f = (sketch ? ix->sketch_src : ix->hash_src).mh_fns[i];
  *perm_bits = f.perm_bits;
  *len = f.perm.size();
  return f.perm.data();
}
// Set-format dataset (jaccard): per-point lengths + concatenated tokens.
uint64_t clann_ref_set_total_tokens(void* h) {
  return static_cast<ParsedIndex*>(h)->set_tokens.size();
}
const uint64_t* clann_ref_set_lens(void* h) {
  return static_cast<ParsedIndex*>(h)->set_lens.data();
}
const uint32_t* clann_ref_set_tokens(void* h) {
  return static_cast<ParsedIndex*>(h)->set_tokens.data();
}
void clann_ref_sketch_source_info(void* h, uint32_t* num_hashers,
                                  uint32_t* fph, uint32_t* bits_per_fn,
                                  uint32_t* bits_to_cut) {
  auto& s = static_cast<ParsedIndex*>(h)->sketch_src.info;
  *num_hashers = s.num_hashers;
  *fph = s.functions_per_hasher;
  *bits_per_fn = s.bits_per_function;
  *bits_to_cut = s.bits_to_cut;
}
uint32_t clann_ref_num_sketch_mh_fns(void* h) {
  return static_cast<uint32_t>(
      static_cast<ParsedIndex*>(h)->sketch_src.mh_fns.size());
}
uint32_t clann_ref_num_hash_mh_fns(void* h) {
  return static_cast<uint32_t>(
      static_cast<ParsedIndex*>(h)->hash_src.mh_fns.size());
}

// ---------------------------------------------------------------- write --

// Writes a reference-loadable stream for a SimHash-family index with an
// independent source. All arrays are caller-provided flat buffers.
// Returns a handle whose buffer is fetched with clann_ref_out_{data,len}.
void* clann_ref_write_simhash(
    uint32_t dims, uint32_t storage_len, uint32_t n, const int16_t* data,
    // sketch machinery: planes (num_sketch_fns x storage_len), sketches
    uint32_t num_sketch_fns, const int16_t* sketch_planes,
    uint64_t num_sketch_words, const uint64_t* sketches,
    uint32_t sketch_hashers, uint32_t sketch_fph, uint32_t sketch_cut,
    // table machinery
    uint32_t num_hash_fns, const int16_t* hash_planes, uint32_t num_hashers,
    uint32_t fph, uint32_t bits_to_cut,
    // tables: concatenated per-map arrays with per-map length
    uint32_t num_maps, const uint64_t* map_lens, const uint32_t* map_indices,
    const uint32_t* map_hashes, uint32_t last_rebuild, uint32_t use_chunks) {
  auto* out = new Writer();
  // Dataset
  out->set<uint32_t>(dims);
  out->set<uint32_t>(storage_len);
  out->set<uint32_t>(n);
  out->put(data, size_t(n) * storage_len * 2);
  // Filterer: args tag + (empty SimHashArgs) + source + sketches
  out->set<uint32_t>(0);  // HashSourceType::Independent
  // source: family desc
  out->set<uint32_t>(dims);
  out->set<uint32_t>(storage_len);
  out->set<uint64_t>(num_sketch_fns);
  for (uint32_t i = 0; i < num_sketch_fns; i++) {
    out->set<uint32_t>(storage_len);
    out->put(sketch_planes + size_t(i) * storage_len, size_t(storage_len) * 2);
  }
  out->set<uint32_t>(sketch_hashers);
  out->set<uint32_t>(sketch_fph);
  out->set<uint8_t>(1);  // SimHash bits_per_function
  // next_function: dead state in the reference (initialized 0 at
  // independent.hpp:15, serialized at :66, never incremented anywhere) —
  // genuine reference streams always carry 0, so 0 keeps re-emission
  // byte-identical (validated against real C++ bytes in
  // tests/test_reference_cross.py)
  out->set<uint32_t>(0);
  out->set<uint32_t>(sketch_cut);
  out->set<uint64_t>(num_sketch_words);
  out->put(sketches, num_sketch_words * 8);
  // HashArgs: independent + SimHashArgs (empty)
  out->set<uint32_t>(0);
  // has_hash_source
  out->set<uint8_t>(1);
  // source
  out->set<uint32_t>(dims);
  out->set<uint32_t>(storage_len);
  out->set<uint64_t>(num_hash_fns);
  for (uint32_t i = 0; i < num_hash_fns; i++) {
    out->set<uint32_t>(storage_len);
    out->put(hash_planes + size_t(i) * storage_len, size_t(storage_len) * 2);
  }
  out->set<uint32_t>(num_hashers);
  out->set<uint32_t>(fph);
  out->set<uint8_t>(1);
  out->set<uint32_t>(0);  // next_function: always 0 in reference streams
  out->set<uint32_t>(bits_to_cut);
  // maps (sentinel + directory injection in write_map); with use_chunks the
  // maps are omitted here and emitted via clann_ref_write_chunk instead
  out->set<uint64_t>(num_maps);
  out->set<uint8_t>(use_chunks ? 1 : 0);
  if (!use_chunks) {
    size_t off = 0;
    for (uint32_t m = 0; m < num_maps; m++) {
      write_map(out, map_lens[m], map_indices + off, map_hashes + off);
      off += map_lens[m];
    }
  }
  out->set<uint32_t>(last_rebuild);
  return out;
}

// Writes a reference-loadable stream for an FHT cross-polytope index with
// an independent source (the reference's cosine default,
// similarity_measure/cosine.hpp:16). Layout mirrors write_simhash with the
// CP function/family encodings (crosspolytope.hpp:165-240 + estimates).
void* clann_ref_write_fhtcp(
    uint32_t dims, uint32_t storage_len, uint32_t n, const int16_t* data,
    // sketch machinery (SimHash family, as in the reference default)
    uint32_t num_sketch_fns, const int16_t* sketch_planes,
    uint64_t num_sketch_words, const uint64_t* sketches,
    uint32_t sketch_hashers, uint32_t sketch_fph, uint32_t sketch_cut,
    // table machinery: FHT-CP functions as +-1 sign diagonals
    uint32_t num_hash_fns, int32_t log_dims, uint32_t num_rotations,
    const int8_t* signs,  // (num_hash_fns, num_rotations << log_dims)
    uint32_t est_reps, float est_eps,
    const float* estimates, uint32_t est_rows, uint32_t est_cols,
    uint32_t num_hashers, uint32_t fph, uint32_t bits_to_cut,
    uint32_t num_maps, const uint64_t* map_lens, const uint32_t* map_indices,
    const uint32_t* map_hashes, uint32_t last_rebuild, uint32_t use_chunks) {
  auto* out = new Writer();
  // Dataset
  out->set<uint32_t>(dims);
  out->set<uint32_t>(storage_len);
  out->set<uint32_t>(n);
  out->put(data, size_t(n) * storage_len * 2);
  // Filterer (SimHash sketches)
  out->set<uint32_t>(0);  // independent
  out->set<uint32_t>(dims);
  out->set<uint32_t>(storage_len);
  out->set<uint64_t>(num_sketch_fns);
  for (uint32_t i = 0; i < num_sketch_fns; i++) {
    out->set<uint32_t>(storage_len);
    out->put(sketch_planes + size_t(i) * storage_len, size_t(storage_len) * 2);
  }
  out->set<uint32_t>(sketch_hashers);
  out->set<uint32_t>(sketch_fph);
  out->set<uint8_t>(1);
  out->set<uint32_t>(0);  // next_function: always 0 in reference streams
  out->set<uint32_t>(sketch_cut);
  out->set<uint64_t>(num_sketch_words);
  out->put(sketches, num_sketch_words * 8);
  // HashArgs: independent + FHTCrossPolytopeArgs
  out->set<uint32_t>(0);
  out->set<int32_t>(static_cast<int32_t>(num_rotations));
  out->set<uint32_t>(est_reps);
  out->set<float>(est_eps);
  // has_hash_source
  out->set<uint8_t>(1);
  // source: FHT-CP family = desc + args + estimates
  out->set<uint32_t>(dims);
  out->set<uint32_t>(storage_len);
  out->set<int32_t>(static_cast<int32_t>(num_rotations));
  out->set<uint32_t>(est_reps);
  out->set<float>(est_eps);
  out->set<uint64_t>(est_rows);
  for (uint32_t r = 0; r < est_rows; r++) {
    out->set<uint64_t>(est_cols);
    out->put(estimates + size_t(r) * est_cols, size_t(est_cols) * 4);
  }
  out->set<float>(est_eps);
  // functions
  size_t signs_len = size_t(num_rotations) << log_dims;
  out->set<uint64_t>(num_hash_fns);
  for (uint32_t i = 0; i < num_hash_fns; i++) {
    out->set<int32_t>(static_cast<int32_t>(dims));
    out->set<int32_t>(log_dims);
    out->set<uint32_t>(num_rotations);
    out->put(signs + size_t(i) * signs_len, signs_len);
  }
  out->set<uint32_t>(num_hashers);
  out->set<uint32_t>(fph);
  out->set<uint8_t>(static_cast<uint8_t>(log_dims + 1));
  out->set<uint32_t>(0);  // next_function: always 0 in reference streams
  out->set<uint32_t>(bits_to_cut);
  // maps (same sentinel + directory injection as the simhash writer)
  out->set<uint64_t>(num_maps);
  out->set<uint8_t>(use_chunks ? 1 : 0);
  if (!use_chunks) {
    size_t off = 0;
    for (uint32_t m = 0; m < num_maps; m++) {
      write_map(out, map_lens[m], map_indices + off, map_hashes + off);
      off += map_lens[m];
    }
  }
  out->set<uint32_t>(last_rebuild);
  return out;
}

// One serialized PrefixMap chunk (collection.hpp:171-176 deserialize_chunk /
// serialize_chunks): what upstream's pickle support stores as separate byte
// strings (python_wrapper.cpp append_chunk/serialize_chunks).
void* clann_ref_write_chunk(uint64_t len, const uint32_t* indices,
                            const uint32_t* hashes) {
  auto* out = new Writer();
  write_map(out, len, indices, hashes);
  return out;
}

// ------------------------------------------------------ generic writer --
// Spec-struct writer covering every (family x source) combination the
// reference can instantiate. Field groups are used or ignored per
// family/kind; array pointers may be null when their count is zero.
// Layout must match io/refcodec.py's ctypes RefWriteSpec exactly.

struct RefWriteSpec {
  // dataset
  uint32_t family;        // FamilyKind of the table hash
  uint32_t source_kind;   // SourceKind of the table source
  uint32_t dims;          // dims (cosine) or universe (jaccard)
  uint32_t storage_len;   // padded dims (cosine) or 1 (jaccard)
  uint32_t n;
  uint32_t _pad0;
  const int16_t* unit_data;     // (n, storage_len) Q15, cosine
  const uint64_t* set_lens;     // (n,), jaccard
  const uint32_t* set_tokens;   // concatenated sorted tokens, jaccard
  // index-level HashArgs record (+ the family header constants reused
  // for the source's own family header)
  int32_t num_rotations;
  uint32_t est_reps;
  float est_eps;
  uint32_t mh_rand_bits;
  uint32_t mh_set_size;
  uint32_t pool_size;     // PoolArgs pool_size (bits)
  const float* estimates;       // (est_rows, est_cols) f32, CP families
  uint32_t est_rows;
  uint32_t est_cols;
  // table hash functions (family selects which payload is read)
  uint32_t num_hash_fns;
  uint32_t _pad1;
  const int16_t* planes;        // simhash: (num, storage_len)
  const int8_t* signs;          // fht: (num, rotations << log_dims)
  int32_t log_dims;
  uint32_t rotations;
  const int16_t* cp_matrices;   // cp: (num, (1<<ceil_log(dims))*storage_len)
  const uint64_t* mh_tabs;      // minhash: (num, 1024)
  const uint32_t* mh_perm_bits; // (num,)
  const uint64_t* mh_perm_lens; // (num,)
  const uint32_t* mh_perms;     // concatenated
  // independent-source tail (also the embedded source of a tensor)
  uint32_t num_hashers;
  uint32_t functions_per_hasher;
  uint32_t bits_per_function;
  uint32_t next_function;
  uint32_t bits_to_cut;
  // pool tail
  uint32_t pool_num_tables;
  const uint64_t* pool_index_lens;  // (pool_num_tables,)
  const uint32_t* pool_indices;     // concatenated
  uint32_t pool_bits_per_hasher;
  uint32_t pool_sampling_rep;
  uint32_t pool_bits_to_cut;
  // tensor tail
  uint32_t tens_num_hashers;
  uint32_t tens_next_idx;
  uint32_t tens_num_bits;
  uint32_t _pad2;
  // sketches (filterer; source is always independent — collection.hpp:128
  // defaults IndependentHashArgs for sketches)
  uint32_t num_sketch_fns;
  uint32_t sk_mh_rand_bits;     // MinHash1Bit sketch family args
  uint32_t sk_mh_set_size;
  uint32_t _pad3;
  const int16_t* sketch_planes;     // simhash sketches
  const uint64_t* sk_mh_tabs;       // minhash1bit sketches
  const uint32_t* sk_mh_perm_bits;
  const uint64_t* sk_mh_perm_lens;
  const uint32_t* sk_mh_perms;
  uint32_t sketch_hashers;
  uint32_t sketch_fph;
  uint32_t sketch_bits_per_function;
  uint32_t sketch_cut;
  const uint64_t* sketches;
  uint64_t num_sketch_words;
  // tables
  uint32_t num_maps;
  uint32_t use_chunks;
  const uint64_t* map_lens;
  const uint32_t* map_indices;
  const uint32_t* map_hashes;
  uint32_t last_rebuild;
  uint32_t _pad4;
};

}  // extern "C"

namespace {

void write_estimates(Writer* out, const RefWriteSpec& s) {
  out->set<uint64_t>(s.est_rows);
  for (uint32_t r = 0; r < s.est_rows; r++) {
    out->set<uint64_t>(s.est_cols);
    out->put(s.estimates + size_t(r) * s.est_cols, size_t(s.est_cols) * 4);
  }
  out->set<float>(s.est_eps);
}

// Family header for the source stream (read_family_header's inverse).
// `sketch` selects the sketch-family constants.
void write_family_header(Writer* out, uint32_t family,
                         const RefWriteSpec& s, bool sketch) {
  switch (family) {
    case kFamilySimHash:
      out->set<uint32_t>(s.dims);
      out->set<uint32_t>(s.storage_len);
      break;
    case kFamilyFhtCrossPolytope:
      out->set<uint32_t>(s.dims);
      out->set<uint32_t>(s.storage_len);
      out->set<int32_t>(s.num_rotations);
      out->set<uint32_t>(s.est_reps);
      out->set<float>(s.est_eps);
      write_estimates(out, s);
      break;
    case kFamilyCrossPolytope:
      out->set<uint32_t>(s.dims);
      out->set<uint32_t>(s.storage_len);
      out->set<uint32_t>(s.est_reps);
      out->set<float>(s.est_eps);
      write_estimates(out, s);
      break;
    case kFamilyMinHash:
    case kFamilyMinHash1Bit:
      out->set<uint32_t>(sketch ? s.sk_mh_rand_bits : s.mh_rand_bits);
      out->set<uint32_t>(sketch ? s.sk_mh_set_size : s.mh_set_size);
      break;
  }
}

void write_mh_function(Writer* out, const uint64_t* tabs, uint32_t perm_bits,
                       uint64_t perm_len, const uint32_t* perm) {
  out->put(tabs, 4 * 256 * 8);
  out->set<uint32_t>(perm_bits);
  out->set<uint64_t>(perm_len);
  if (perm_len) out->put(perm, size_t(perm_len) * 4);
}

void write_function(Writer* out, uint32_t family, const RefWriteSpec& s,
                    uint32_t i) {
  switch (family) {
    case kFamilySimHash:
      out->set<uint32_t>(s.storage_len);
      out->put(s.planes + size_t(i) * s.storage_len,
               size_t(s.storage_len) * 2);
      break;
    case kFamilyFhtCrossPolytope: {
      size_t signs_len = size_t(s.rotations) << s.log_dims;
      out->set<int32_t>(static_cast<int32_t>(s.dims));
      out->set<int32_t>(s.log_dims);
      out->set<uint32_t>(s.rotations);
      out->put(s.signs + size_t(i) * signs_len, signs_len);
      break;
    }
    case kFamilyCrossPolytope: {
      uint32_t rows = 1;
      while (rows < s.dims) rows <<= 1;
      size_t mat_len = size_t(rows) * s.storage_len;
      out->set<uint32_t>(s.dims);
      out->set<uint32_t>(s.storage_len);
      out->put(s.cp_matrices + size_t(i) * mat_len, mat_len * 2);
      break;
    }
    case kFamilyMinHash: {
      uint64_t off = 0;
      for (uint32_t j = 0; j < i; j++) off += s.mh_perm_lens[j];
      write_mh_function(out, s.mh_tabs + size_t(i) * 1024,
                        s.mh_perm_bits[i], s.mh_perm_lens[i],
                        s.mh_perms + off);
      break;
    }
  }
}

// HashArgs record (read_args_record's inverse).
void write_args_record(Writer* out, uint32_t family, uint32_t kind,
                       const RefWriteSpec& s, bool sketch) {
  out->set<uint32_t>(kind);
  switch (family) {
    case kFamilySimHash:
      break;
    case kFamilyFhtCrossPolytope:
      out->set<int32_t>(s.num_rotations);
      out->set<uint32_t>(s.est_reps);
      out->set<float>(s.est_eps);
      break;
    case kFamilyCrossPolytope:
      out->set<uint32_t>(s.est_reps);
      out->set<float>(s.est_eps);
      break;
    case kFamilyMinHash:
    case kFamilyMinHash1Bit:
      out->set<uint32_t>(sketch ? s.sk_mh_rand_bits : s.mh_rand_bits);
      break;
  }
  if (kind == kSourcePool) out->set<uint32_t>(s.pool_size);
}

void write_independent_body(Writer* out, uint32_t family,
                            const RefWriteSpec& s) {
  write_family_header(out, family, s, /*sketch=*/false);
  out->set<uint64_t>(s.num_hash_fns);
  for (uint32_t i = 0; i < s.num_hash_fns; i++) {
    write_function(out, family, s, i);
  }
  out->set<uint32_t>(s.num_hashers);
  out->set<uint32_t>(s.functions_per_hasher);
  out->set<uint8_t>(static_cast<uint8_t>(s.bits_per_function));
  out->set<uint32_t>(s.next_function);
  out->set<uint32_t>(s.bits_to_cut);
}

void write_source(Writer* out, uint32_t family, uint32_t kind,
                  const RefWriteSpec& s) {
  switch (kind) {
    case kSourceIndependent:
      write_independent_body(out, family, s);
      break;
    case kSourcePool: {
      write_family_header(out, family, s, /*sketch=*/false);
      out->set<uint64_t>(s.num_hash_fns);
      for (uint32_t i = 0; i < s.num_hash_fns; i++) {
        write_function(out, family, s, i);
      }
      out->set<uint64_t>(s.pool_num_tables);
      uint64_t off = 0;
      for (uint32_t t = 0; t < s.pool_num_tables; t++) {
        uint64_t li = s.pool_index_lens[t];
        out->set<uint64_t>(li);
        out->put(s.pool_indices + off, size_t(li) * 4);
        off += li;
      }
      out->set<uint32_t>(s.pool_num_tables);
      out->set<uint8_t>(static_cast<uint8_t>(s.bits_per_function));
      out->set<uint32_t>(s.pool_bits_per_hasher);
      out->set<uint32_t>(s.pool_sampling_rep);
      out->set<uint32_t>(s.pool_bits_to_cut);
      break;
    }
    case kSourceTensor:
      write_independent_body(out, family, s);
      out->set<uint32_t>(s.tens_num_hashers);
      out->set<uint32_t>(s.tens_next_idx);
      out->set<uint32_t>(s.tens_num_bits);
      break;
  }
}

}  // namespace

extern "C" {

void* clann_ref_write_v2(const RefWriteSpec* sp) {
  const RefWriteSpec& s = *sp;
  auto* out = new Writer();
  uint32_t sk_family = sketch_family_for(static_cast<int32_t>(s.family));
  // Dataset
  out->set<uint32_t>(s.dims);
  out->set<uint32_t>(s.storage_len);
  out->set<uint32_t>(s.n);
  if (s.family == kFamilyMinHash) {
    uint64_t off = 0;
    for (uint32_t i = 0; i < s.n; i++) {
      uint64_t len = s.set_lens[i];
      out->set<uint64_t>(len);
      out->put(s.set_tokens + off, size_t(len) * 4);
      off += len;
    }
  } else {
    out->put(s.unit_data, size_t(s.n) * s.storage_len * 2);
  }
  // Filterer: HashArgs + independent source + sketches
  write_args_record(out, sk_family, kSourceIndependent, s, /*sketch=*/true);
  write_family_header(out, sk_family, s, /*sketch=*/true);
  out->set<uint64_t>(s.num_sketch_fns);
  for (uint32_t i = 0; i < s.num_sketch_fns; i++) {
    if (sk_family == kFamilyMinHash1Bit) {
      uint64_t off = 0;
      for (uint32_t j = 0; j < i; j++) off += s.sk_mh_perm_lens[j];
      write_mh_function(out, s.sk_mh_tabs + size_t(i) * 1024,
                        s.sk_mh_perm_bits[i], s.sk_mh_perm_lens[i],
                        s.sk_mh_perms + off);
    } else {
      out->set<uint32_t>(s.storage_len);
      out->put(s.sketch_planes + size_t(i) * s.storage_len,
               size_t(s.storage_len) * 2);
    }
  }
  out->set<uint32_t>(s.sketch_hashers);
  out->set<uint32_t>(s.sketch_fph);
  out->set<uint8_t>(static_cast<uint8_t>(s.sketch_bits_per_function));
  out->set<uint32_t>(0);  // next_function: always 0 in reference streams
  out->set<uint32_t>(s.sketch_cut);
  out->set<uint64_t>(s.num_sketch_words);
  out->put(s.sketches, s.num_sketch_words * 8);
  // Index-level HashArgs + source
  write_args_record(out, s.family, s.source_kind, s, /*sketch=*/false);
  out->set<uint8_t>(1);  // has_hash_source
  write_source(out, s.family, s.source_kind, s);
  // maps
  out->set<uint64_t>(s.num_maps);
  out->set<uint8_t>(s.use_chunks ? 1 : 0);
  if (!s.use_chunks) {
    size_t off = 0;
    for (uint32_t m = 0; m < s.num_maps; m++) {
      write_map(out, s.map_lens[m], s.map_indices + off, s.map_hashes + off);
      off += s.map_lens[m];
    }
  }
  out->set<uint32_t>(s.last_rebuild);
  return out;
}

const uint8_t* clann_ref_out_data(void* h) {
  return static_cast<Writer*>(h)->buf.data();
}
uint64_t clann_ref_out_len(void* h) {
  return static_cast<Writer*>(h)->buf.size();
}
void clann_ref_out_free(void* h) { delete static_cast<Writer*>(h); }

}  // extern "C"
