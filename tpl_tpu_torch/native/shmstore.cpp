// Native shared-memory store engine of the PyTorch port.
//
// The reference's IPC substrate is structstore: C++ shared-memory stores
// with a per-store process-shared mutex (reference: library/tpl/util.py:
// 310-333 and the structstore dependency pinned in docker/
// tpl_base.Dockerfile). This is the native core of the mmap-backed
// stores in tpl_tpu_torch/util/shm_store.py, the port's own copy of
// tpl_tpu/native/shmstore.cpp:
//
//  - one file-backed mapping per store under the port's store directory
//    (<tmp>/tpl-tpu-torch-shm-<uid>/, never the JAX package's)
//  - a ROBUST process-shared pthread mutex in the mapping: if a process
//    dies while holding the lock, the next locker gets EOWNERDEAD,
//    marks the mutex consistent and keeps going
//  - double-buffered payload slots: writers fill the inactive slot and
//    then flip `active` + bump `version`; a writer crash mid-write can
//    never tear the readable slot (the python fallback's flock releases
//    on death too, but a die-mid-write there corrupts the single buffer)
//
//  - a file whose content is neither all zero nor this engine's magic
//    (for example a live store of the Python engine) is refused, never
//    re-initialised
//
// The native engine buys crash-consistency; the store round trip is the
// Python side's pickling.
//
// Serialization stays in Python (pickle blobs), matching the store's
// snapshot-in/snapshot-out usage; this layer only moves bytes.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/file.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t MAGIC = 0x31304d4853'4c5054ull;  // "TPLSHM01"

struct ShmHeader {
    uint64_t magic;
    uint32_t init_state;  // 2 = mutex initialized
    uint32_t active;      // readable slot index (0/1)
    pthread_mutex_t mutex;
    uint64_t version;
    uint64_t length[2];   // payload length per slot
};

struct Store {
    int fd;
    uint8_t *map;
    size_t map_size;
    int64_t slot_size;
    bool owns_lock;
};

inline ShmHeader *header(Store *s) {
    return reinterpret_cast<ShmHeader *>(s->map);
}

inline uint8_t *slot(Store *s, int i) {
    return s->map + sizeof(ShmHeader) + i * s->slot_size;
}

}  // namespace

extern "C" {

// Open (creating/initializing if needed) a store of `size` payload bytes.
// Returns an opaque handle with *status 0 (an existing store) or 2 (this
// call initialized it, under the file's flock), or 0 with *status 1 (the
// file holds content that is neither all zero nor this engine's store) or
// -1 (a system call failed).
void *tpl_shm_open(const char *path, int64_t size, int *status) {
    *status = -1;
    size_t map_size = sizeof(ShmHeader) + 2 * static_cast<size_t>(size);
    int fd = open(path, O_RDWR | O_CREAT, 0600);
    if (fd < 0) return nullptr;

    // initialization protocol: the in-file mutex can only be trusted
    // once init_state == 2, so creation races are settled with flock
    if (flock(fd, LOCK_EX) != 0) { close(fd); return nullptr; }

    struct stat st;
    if (fstat(fd, &st) != 0) { flock(fd, LOCK_UN); close(fd); return nullptr; }
    size_t old_size = static_cast<size_t>(st.st_size);
    auto *probe = static_cast<uint8_t *>(
        old_size > 0 ? mmap(nullptr, old_size, PROT_READ, MAP_SHARED, fd, 0)
                     : nullptr);
    if (probe == MAP_FAILED) { flock(fd, LOCK_UN); close(fd); return nullptr; }
    bool ours = old_size >= sizeof(ShmHeader) &&
                reinterpret_cast<const ShmHeader *>(probe)->magic == MAGIC;
    bool zero = true;
    for (size_t i = 0; !ours && zero && i < old_size; ++i)
        zero = probe[i] == 0;
    if (probe) munmap(probe, old_size);
    if (!ours && !zero) {
        flock(fd, LOCK_UN); close(fd); *status = 1; return nullptr;
    }

    if (old_size < map_size && ftruncate(fd, map_size) != 0) {
        flock(fd, LOCK_UN); close(fd); return nullptr;
    }
    if (old_size > map_size)
        map_size = old_size;

    void *map = mmap(nullptr, map_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
    if (map == MAP_FAILED) { flock(fd, LOCK_UN); close(fd); return nullptr; }

    auto *hdr = reinterpret_cast<ShmHeader *>(map);
    bool created = hdr->magic != MAGIC || hdr->init_state != 2;
    if (created) {
        std::memset(hdr, 0, sizeof(ShmHeader));
        pthread_mutexattr_t attr;
        pthread_mutexattr_init(&attr);
        pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
        pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
        if (pthread_mutex_init(&hdr->mutex, &attr) != 0) {
            pthread_mutexattr_destroy(&attr);
            munmap(map, map_size); flock(fd, LOCK_UN); close(fd);
            return nullptr;
        }
        pthread_mutexattr_destroy(&attr);
        hdr->version = 0;
        hdr->length[0] = hdr->length[1] = 0;
        hdr->active = 0;
        std::atomic_thread_fence(std::memory_order_release);
        hdr->init_state = 2;
        hdr->magic = MAGIC;
    }
    flock(fd, LOCK_UN);

    auto *s = new Store{fd, static_cast<uint8_t *>(map), map_size,
                        (static_cast<int64_t>(map_size)
                         - static_cast<int64_t>(sizeof(ShmHeader))) / 2,
                        false};
    *status = created ? 2 : 0;
    return s;
}

// Lock: 0 = ok, 1 = recovered from a dead owner (data is the last
// complete write), -1 = error.
int tpl_shm_lock(void *handle) {
    auto *s = static_cast<Store *>(handle);
    int r = pthread_mutex_lock(&header(s)->mutex);
    if (r == EOWNERDEAD) {
        pthread_mutex_consistent(&header(s)->mutex);
        s->owns_lock = true;
        return 1;
    }
    if (r != 0) return -1;
    s->owns_lock = true;
    return 0;
}

int tpl_shm_unlock(void *handle) {
    auto *s = static_cast<Store *>(handle);
    s->owns_lock = false;
    return pthread_mutex_unlock(&header(s)->mutex) == 0 ? 0 : -1;
}

uint64_t tpl_shm_version(void *handle) {
    return header(static_cast<Store *>(handle))->version;
}

int64_t tpl_shm_capacity(void *handle) {
    return static_cast<Store *>(handle)->slot_size;
}

// Read the active slot into buf (caller holds the lock). Returns the
// payload length, or -1 if buf is too small.
int64_t tpl_shm_read(void *handle, uint8_t *buf, int64_t maxlen,
                     uint64_t *version) {
    auto *s = static_cast<Store *>(handle);
    ShmHeader *hdr = header(s);
    int a = hdr->active & 1;
    int64_t len = static_cast<int64_t>(hdr->length[a]);
    if (version) *version = hdr->version;
    if (len > maxlen) return -1;
    if (len > 0) std::memcpy(buf, slot(s, a), len);
    return len;
}

// Write buf into the inactive slot and flip it live (caller holds the
// lock). Returns the new version, or 0 on overflow.
uint64_t tpl_shm_write(void *handle, const uint8_t *buf, int64_t len) {
    auto *s = static_cast<Store *>(handle);
    ShmHeader *hdr = header(s);
    if (len > s->slot_size) return 0;
    int b = (hdr->active & 1) ^ 1;
    if (len > 0) std::memcpy(slot(s, b), buf, len);
    hdr->length[b] = len;
    std::atomic_thread_fence(std::memory_order_release);
    hdr->active = b;
    return ++hdr->version;
}

void tpl_shm_close(void *handle) {
    auto *s = static_cast<Store *>(handle);
    if (s->owns_lock) pthread_mutex_unlock(&header(s)->mutex);
    munmap(s->map, s->map_size);
    close(s->fd);
    delete s;
}

}  // extern "C"
