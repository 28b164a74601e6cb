// Host-side paged KV-cache manager: radix prefix cache + free-page allocator.
//
// The port's own copy of the JAX package's native runtime source
// (csrc/cache_manager.cpp at the repository root), built by
// runtime/cache_manager.py with g++; plain host C++, no CUDA.  This C++ core
// owns:
//   - a radix tree over token sequences, chunked by page_size, mapping prefixes to
//     physical page ids with reference counts;
//   - the free-page list, with LRU eviction of unreferenced cached pages;
//   - longest-prefix match / insert / release, all O(tokens).
//
// Exposed as a plain C API consumed via ctypes (no pybind11 in the image).

#include <cstdint>
#include <map>
#include <memory>
#include <vector>

namespace {

struct Node {
    // key: token chunk (exactly page_size tokens except possibly a tail chunk,
    // which is never cached — only full pages are shared)
    std::vector<int32_t> tokens;
    int32_t page = -1;
    int64_t refcount = 0;
    uint64_t last_use = 0;
    Node* parent = nullptr;
    // keyed by the FULL token chunk: first-token keying would make two
    // different chunks that share a first token collide (silent overwrite =
    // leaked pages + dangling refcounts)
    std::map<std::vector<int32_t>, std::unique_ptr<Node>> children;
};

struct CacheManager {
    int64_t num_pages;
    int32_t page_size;
    uint64_t tick = 0;
    std::vector<int32_t> free_pages;   // stack of free physical pages
    Node root;
    int64_t cached_pages = 0;

    explicit CacheManager(int64_t n, int32_t ps) : num_pages(n), page_size(ps) {
        free_pages.reserve(n);
        for (int64_t i = n - 1; i >= 0; --i) free_pages.push_back(static_cast<int32_t>(i));
    }
};

// Collect evictable (refcount==0) leaves, remove the least-recently-used one.
// Returns the freed page id or -1.
int32_t evict_one(CacheManager* cm) {
    Node* victim = nullptr;
    // DFS for the LRU refcount-0 leaf
    std::vector<Node*> stack{&cm->root};
    while (!stack.empty()) {
        Node* n = stack.back();
        stack.pop_back();
        for (auto& kv : n->children) stack.push_back(kv.second.get());
        if (n != &cm->root && n->children.empty() && n->refcount == 0) {
            if (!victim || n->last_use < victim->last_use) victim = n;
        }
    }
    if (!victim) return -1;
    int32_t page = victim->page;
    victim->parent->children.erase(victim->tokens);
    cm->cached_pages--;
    return page;
}

}  // namespace

extern "C" {

void* cm_create(int64_t num_pages, int32_t page_size) {
    return new CacheManager(num_pages, page_size);
}

void cm_destroy(void* h) { delete static_cast<CacheManager*>(h); }

int64_t cm_free_count(void* h) {
    return static_cast<int64_t>(static_cast<CacheManager*>(h)->free_pages.size());
}

int64_t cm_cached_count(void* h) { return static_cast<CacheManager*>(h)->cached_pages; }

// Longest prefix match: fills out_pages with up to `cap` matched page ids and
// bumps their refcounts (caller must cm_release later).  Returns matched tokens.
int64_t cm_match(void* hptr, const int32_t* tokens, int64_t n, int32_t* out_pages,
                 int64_t cap) {
    auto* cm = static_cast<CacheManager*>(hptr);
    cm->tick++;
    Node* cur = &cm->root;
    int64_t matched = 0, pages = 0;
    while (matched + cm->page_size <= n && pages < cap) {
        std::vector<int32_t> key(tokens + matched, tokens + matched + cm->page_size);
        auto it = cur->children.find(key);
        if (it == cur->children.end()) break;
        cur = it->second.get();
        cur->refcount++;
        cur->last_use = cm->tick;
        out_pages[pages++] = cur->page;
        matched += cm->page_size;
    }
    return matched;
}

// Insert full-page chunks of `tokens` mapped to `pages` (one page per chunk).
// Refcounts of newly inserted nodes start at `ref` (1 = held by the inserter).
// Returns the number of pages inserted (pre-existing prefixes are skipped and
// their pages in `pages` are returned to the free list via out_dup).
int64_t cm_insert(void* hptr, const int32_t* tokens, int64_t n, const int32_t* pages,
                  int64_t npages, int32_t ref, int32_t* out_dup_pages) {
    auto* cm = static_cast<CacheManager*>(hptr);
    cm->tick++;
    Node* cur = &cm->root;
    int64_t inserted = 0, dups = 0, pi = 0;
    for (int64_t off = 0; off + cm->page_size <= n && pi < npages; off += cm->page_size, ++pi) {
        std::vector<int32_t> key(tokens + off, tokens + off + cm->page_size);
        auto it = cur->children.find(key);
        if (it != cur->children.end()) {
            cur = it->second.get();
            cur->last_use = cm->tick;
            out_dup_pages[dups++] = pages[pi];  // duplicate — caller's page unused
            continue;
        }
        auto node = std::make_unique<Node>();
        node->tokens.assign(tokens + off, tokens + off + cm->page_size);
        node->page = pages[pi];
        node->refcount = ref;
        node->last_use = cm->tick;
        node->parent = cur;
        Node* raw = node.get();
        cur->children[key] = std::move(node);
        cur = raw;
        cm->cached_pages++;
        inserted++;
    }
    return (inserted << 32) | static_cast<int64_t>(dups);
}

// Decrement refcounts along the prefix (inverse of cm_match / insert holds).
void cm_release(void* hptr, const int32_t* tokens, int64_t n) {
    auto* cm = static_cast<CacheManager*>(hptr);
    Node* cur = &cm->root;
    for (int64_t off = 0; off + cm->page_size <= n; off += cm->page_size) {
        std::vector<int32_t> key(tokens + off, tokens + off + cm->page_size);
        auto it = cur->children.find(key);
        if (it == cur->children.end()) break;
        cur = it->second.get();
        if (cur->refcount > 0) cur->refcount--;
    }
}

// Allocate `count` free pages, evicting LRU unreferenced cache pages as needed.
// Returns pages actually allocated (may be < count when memory is exhausted).
int64_t cm_alloc(void* hptr, int64_t count, int32_t* out) {
    auto* cm = static_cast<CacheManager*>(hptr);
    int64_t got = 0;
    while (got < count) {
        if (!cm->free_pages.empty()) {
            out[got++] = cm->free_pages.back();
            cm->free_pages.pop_back();
            continue;
        }
        int32_t evicted = evict_one(cm);
        if (evicted < 0) break;
        out[got++] = evicted;
    }
    return got;
}

// Return pages to the free list (for pages never inserted into the radix tree).
void cm_free(void* hptr, const int32_t* pages, int64_t count) {
    auto* cm = static_cast<CacheManager*>(hptr);
    for (int64_t i = 0; i < count; ++i) cm->free_pages.push_back(pages[i]);
}

}  // extern "C"
