// Native needle map — RAM-frugal id -> (offset, size) index.
//
// The reference's CompactMap (weed/storage/needle_map/compact_map.go,
// SURVEY.md §2 "Needle map") exists because the needle index IS the
// Haystack trick: billions of entries must fit in RAM, so a Go
// map[uint64]... (~50+ B/entry of header+bucket overhead) is replaced
// with purpose-built segmented arrays. The Python-dict CompactMap pays
// ~200 B per entry; this native table stores 16-byte packed entries in
// one open-addressing array (~24 B/slot at the 0.7 load ceiling,
// including the occupancy byte) and replays .idx journals at memcpy
// speed — the same role, C++ instead of Go.
//
// Layout: linear probing, power-of-two capacity, grow at 70% load.
// Deletes keep the slot (needle tombstone IS data: deleted_bytes feeds
// vacuum scheduling) with size = 0xFFFFFFFF, mirroring the on-disk
// .idx tombstone sentinel.
//
// Build: g++ -O3 -shared -fPIC needle_map.cpp -o libneedle_map.so
// (storage/needle_map_native.py does this at first use, into build/).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr uint32_t TOMBSTONE = 0xFFFFFFFFu;

struct Entry {
    uint64_t key;
    uint32_t off;
    uint32_t size;
};

struct Map {
    Entry *slots;
    uint8_t *used;
    uint64_t cap;      // power of two
    uint64_t filled;   // used slots (live + tombstoned)
    // CompactMap bookkeeping (store status + heartbeats + vacuum)
    uint64_t file_count;
    uint64_t deleted_count;
    uint64_t deleted_bytes;
    uint64_t max_off;
    uint64_t max_key;
    uint64_t live;
};

inline uint64_t hash_key(uint64_t k) {
    // splitmix64 finalizer: full-avalanche, cheap
    k ^= k >> 30; k *= 0xbf58476d1ce4e5b9ULL;
    k ^= k >> 27; k *= 0x94d049bb133111ebULL;
    k ^= k >> 31;
    return k;
}

inline uint64_t probe_slot(const Map *m, uint64_t key, bool *found) {
    uint64_t mask = m->cap - 1;
    uint64_t i = hash_key(key) & mask;
    while (m->used[i]) {
        if (m->slots[i].key == key) { *found = true; return i; }
        i = (i + 1) & mask;
    }
    *found = false;
    return i;
}

bool grow(Map *m);

// Raw slot insert/update, no counter bookkeeping.
// Returns 1 = replaced existing (old size in *old_size), 0 = inserted
// new, -1 = allocation failure (nothing changed).
int raw_set(Map *m, uint64_t key, uint32_t off, uint32_t size,
            uint32_t *old_size) {
    if ((m->filled + 1) * 10 >= m->cap * 7) {
        if (!grow(m)) return -1;
    }
    bool found;
    uint64_t i = probe_slot(m, key, &found);
    if (found) {
        *old_size = m->slots[i].size;
        m->slots[i].off = off;
        m->slots[i].size = size;
        return 1;
    }
    m->used[i] = 1;
    m->filled++;
    m->slots[i] = Entry{key, off, size};
    return 0;
}

bool grow(Map *m) {
    uint64_t ncap = m->cap * 2;
    Entry *nslots = (Entry *)calloc(ncap, sizeof(Entry));
    uint8_t *nused = (uint8_t *)calloc(ncap, 1);
    if (!nslots || !nused) { free(nslots); free(nused); return false; }
    Entry *oslots = m->slots;
    uint8_t *oused = m->used;
    uint64_t ocap = m->cap;
    m->slots = nslots; m->used = nused; m->cap = ncap;
    uint64_t mask = ncap - 1;
    for (uint64_t i = 0; i < ocap; i++) {
        if (!oused[i]) continue;
        uint64_t j = hash_key(oslots[i].key) & mask;
        while (nused[j]) j = (j + 1) & mask;
        nused[j] = 1;
        nslots[j] = oslots[i];
    }
    free(oslots);
    free(oused);
    return true;
}

}  // namespace

extern "C" {

void *nm_new(uint64_t cap_hint) {
    uint64_t cap = 1024;
    while (cap * 7 < cap_hint * 10) cap <<= 1;  // fit hint under 70%
    Map *m = (Map *)calloc(1, sizeof(Map));
    if (!m) return nullptr;
    m->cap = cap;
    m->slots = (Entry *)calloc(cap, sizeof(Entry));
    m->used = (uint8_t *)calloc(cap, 1);
    if (!m->slots || !m->used) {
        free(m->slots); free(m->used); free(m);
        return nullptr;
    }
    return m;
}

void nm_free(void *h) {
    if (!h) return;
    Map *m = (Map *)h;
    free(m->slots);
    free(m->used);
    free(m);
}

// set: returns 0 ok, -1 allocation failure
int nm_set(void *h, uint64_t key, uint32_t off, uint32_t size) {
    Map *m = (Map *)h;
    uint32_t old = 0;
    int existed = raw_set(m, key, off, size, &old);
    if (existed < 0) return -1;
    if (existed) {
        if (old != TOMBSTONE) {       // overwrote a live entry
            m->deleted_count++;
            m->deleted_bytes += old;
        } else {
            m->live++;                // tombstone resurrected
        }
    } else {
        m->live++;
    }
    m->file_count++;
    if (off > m->max_off) m->max_off = off;
    if (key > m->max_key) m->max_key = key;
    return 0;
}

// delete: 1 when a live entry was tombstoned, 0 otherwise
int nm_delete(void *h, uint64_t key) {
    Map *m = (Map *)h;
    bool found;
    uint64_t i = probe_slot(m, key, &found);
    if (!found || m->slots[i].size == TOMBSTONE) return 0;
    m->deleted_count++;
    m->deleted_bytes += m->slots[i].size;
    m->slots[i].size = TOMBSTONE;
    m->live--;
    return 1;
}

// get: 1 when live, fills off/size
int nm_get(void *h, uint64_t key, uint32_t *off, uint32_t *size) {
    Map *m = (Map *)h;
    bool found;
    uint64_t i = probe_slot(m, key, &found);
    if (!found || m->slots[i].size == TOMBSTONE) return 0;
    *off = m->slots[i].off;
    *size = m->slots[i].size;
    return 1;
}

uint64_t nm_live(void *h) { return ((Map *)h)->live; }

void nm_stats(void *h, uint64_t *file_count, uint64_t *deleted_count,
              uint64_t *deleted_bytes, uint64_t *max_off,
              uint64_t *max_key) {
    Map *m = (Map *)h;
    *file_count = m->file_count;
    *deleted_count = m->deleted_count;
    *deleted_bytes = m->deleted_bytes;
    *max_off = m->max_off;
    *max_key = m->max_key;
}

// Dump up to max_n LIVE entries (unsorted) into parallel arrays;
// returns the count written.
uint64_t nm_dump_live(void *h, uint64_t *keys, uint32_t *offs,
                      uint32_t *sizes, uint64_t max_n) {
    Map *m = (Map *)h;
    uint64_t n = 0;
    for (uint64_t i = 0; i < m->cap && n < max_n; i++) {
        if (!m->used[i] || m->slots[i].size == TOMBSTONE) continue;
        keys[n] = m->slots[i].key;
        offs[n] = m->slots[i].off;
        sizes[n] = m->slots[i].size;
        n++;
    }
    return n;
}

// Replay n 16-byte BIG-ENDIAN .idx records (key u64, offset u32, size
// u32 — idx.go's on-disk layout). Returns records applied, or a value
// < n on allocation failure.
uint64_t nm_load_idx(void *h, const uint8_t *buf, uint64_t n) {
    for (uint64_t r = 0; r < n; r++) {
        const uint8_t *p = buf + 16 * r;
        uint64_t key = 0;
        for (int b = 0; b < 8; b++) key = (key << 8) | p[b];
        uint32_t off = ((uint32_t)p[8] << 24) | ((uint32_t)p[9] << 16) |
                       ((uint32_t)p[10] << 8) | p[11];
        uint32_t size = ((uint32_t)p[12] << 24) | ((uint32_t)p[13] << 16) |
                        ((uint32_t)p[14] << 8) | p[15];
        if (size == TOMBSTONE) {
            nm_delete(h, key);
        } else if (nm_set(h, key, off, size) != 0) {
            return r;
        }
    }
    return n;
}

}  // extern "C"
